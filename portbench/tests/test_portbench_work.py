"""Work counts from shapes alone, and the traffic's layouts."""
import json
import math

import pytest
import torch

from portbench import peaks, spec, traffic, work


@pytest.mark.parametrize("n,rows", [(2, 1), (8, 3), (1024, 5), (16384, 4096), (1 << 20, 64)])
def test_c2c_counts(n, rows):
    assert work.c2c_flops(n, rows) == 5 * n * math.log2(n) * rows
    assert work.c2c_bytes(n, rows, "bfloat16") == 8 * n * rows  # 4 B in, 4 B out
    assert work.c2c_bytes(n, rows, "float32") == 16 * n * rows


def test_bound_takes_the_larger():
    # 16384 x 4096 bf16: 537 MB at 3.35 TB/s outweighs 4.7 GFLOP at 989 TFLOP/s.
    flops, nbytes = work.c2c_flops(16384, 4096), work.c2c_bytes(16384, 4096, "bfloat16")
    assert work.bound_seconds(flops, nbytes, "bf16_dense") == nbytes / peaks.HBM_BYTES_PER_S
    assert work.bound_seconds(flops, nbytes, "bf16_dense") == pytest.approx(160.25e-6, rel=1e-3)
    assert work.bound_seconds(1e12, 1.0, "bf16_dense") == 1e12 / 989e12


def test_entry_work_matches_work_py():
    entry = spec.load_module("entries", "c2c")
    config = {"n": 4096, "precision": "bfloat16"}
    assert entry.work_of_call(config, 7) == (work.c2c_flops(4096, 7),
                                             work.c2c_bytes(4096, 7, "bfloat16"))


@pytest.mark.parametrize("config,traffic_name,rows,pool", [
    ("c2c_n16384_bf16", "bulk", 4096, 1), ("c2c_n2p20_bf16", "batch20", 20, 3),
    ("c2c_n16384_bf16", "batch20", 20, 204), ("c2c_n2p20_bf16", "bulk", 4096, 1)])
def test_traffic_layouts(config, traffic_name, rows, pool):
    """As many whole batches as fit the pool's bytes, and never fewer than one."""
    cfg = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())
    mix = json.loads((spec.HERE / "traffic" / f"{traffic_name}.json").read_text())
    lay = traffic.layout(mix, cfg)
    assert (lay.rows, lay.pool, lay.step) == (rows, pool, ("forward", "inverse"))
    batch = lay.rows * lay.n * 4  # bytes of bf16 re and im planes
    assert pool == 1 or 0 <= mix["pool_bytes"] - pool * batch < batch


def test_layout_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        traffic.layout({"rows_per_call": 0, "pool_bytes": 1, "step": ["forward"]},
                       {"n": 1024, "precision": "bfloat16"})


def test_pools_follow_the_seed():
    lay = traffic.Layout(rows=3, n=16, pool=2, step=("forward", "inverse"))
    cpu = torch.device("cpu")
    a = traffic.make_pools(lay, "bfloat16", 2**31 + 5, cpu)
    b = traffic.make_pools(lay, "bfloat16", 2**31 + 5, cpu)
    c = traffic.make_pools(lay, "bfloat16", 2**31 + 6, cpu)
    for d in lay.directions:
        for (ra, ia), (rb, ib), (rc, ic) in zip(a[d], b[d], c[d]):
            assert ra.dtype == torch.bfloat16 and ra.shape == (3, 16) and ra.is_contiguous()
            assert torch.equal(ra, rb) and torch.equal(ia, ib)
            assert not torch.equal(ra, rc)
    assert not torch.equal(a["forward"][0][0], a["inverse"][0][0])
