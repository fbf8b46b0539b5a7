"""The port's tuner cache (tensorfft_tpu_torch/tuning) and
``create_plan(tuning="auto")`` against the JAX package's.

The cache cases mirror tests/test_tuning_io.py's, plus the two writer
defects the port does not copy: a shared temp path without a lock, and an
exact-batch key where the last writer wins.
"""
import dataclasses
import json
import os
import threading

import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.tuning import TunerCache as JaxTunerCache
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.tuning import TunerCache, default_cache_path
from tensorfft_tpu_torch.tuning import cache as cache_mod

torch.set_num_threads(1)


def _fields(plan):
    d = dataclasses.asdict(plan)
    d["precision"] = plan.precision.value
    d["strategy"] = plan.strategy.value
    return d


def test_cache_roundtrip(tmp_path):
    cache = TunerCache(tmp_path / "cache.json")
    cache.put(4096, "bfloat16", "cpu",
              {"radices": [64, 64], "strategy": "fused", "lane_tile": 128,
               "time_us": 1.0, "gflops": 2.0})
    cache.save()
    tuning = TunerCache(tmp_path / "cache.json").get(4096, "bfloat16", "cpu")
    assert tuning["radices"] == (64, 64)
    assert "time_us" not in tuning and "gflops" not in tuning
    assert tt.create_plan(4096, tuning=tuning).radices == (64, 64)
    assert TunerCache(tmp_path / "cache.json").get(8192, "bfloat16", "cpu") is None
    # Missing file: an empty cache.
    assert len(TunerCache(tmp_path / "absent.json")) == 0


def test_default_path_and_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("TENSORFFT_TUNER_CACHE", raising=False)
    path = default_cache_path()
    assert path.name == "tuner_cache.json"
    assert path.parent.name == "tuning" and path.parent.parent.name == "tensorfft_tpu_torch"
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(tmp_path / "c.json"))
    assert default_cache_path() == tmp_path / "c.json"
    assert TunerCache().path == tmp_path / "c.json"


def test_cache_batch_aware_keys(tmp_path):
    c = TunerCache(tmp_path / "cache.json")
    c.put(4096, "bfloat16", "cuda", {"radices": [64, 64]}, batch=1024)
    c.put(4096, "bfloat16", "cuda", {"radices": [32, 128]}, batch=4096)
    assert c.get(4096, "bfloat16", "cuda", batch=1024)["radices"] == (64, 64)
    assert c.get(4096, "bfloat16", "cuda", batch=4096)["radices"] == (32, 128)
    # The blind key holds the largest-batch winner; a smaller-batch retune
    # does not demote it, and an unknown batch falls back to it.
    assert c.get(4096, "bfloat16", "cuda")["radices"] == (32, 128)
    c.put(4096, "bfloat16", "cuda", {"radices": [16, 256]}, batch=512)
    assert c.get(4096, "bfloat16", "cuda")["radices"] == (32, 128)
    assert c.get(4096, "bfloat16", "cuda", batch=64)["radices"] == (32, 128)
    c.save()
    c2 = TunerCache(tmp_path / "cache.json")
    assert c2.get(4096, "bfloat16", "cuda", batch=1024)["radices"] == (64, 64)
    assert "batch" not in c2.get(4096, "bfloat16", "cuda", batch=1024)
    # Keys carry the platform: a cpu lookup sees none of the cuda entries.
    assert c2.get(4096, "bfloat16", "cpu") is None


def test_cache_rejects_nonfinite_entries(tmp_path):
    c = TunerCache(tmp_path / "cache.json")
    with pytest.raises(ValueError, match="non-finite"):
        c.put(16384, "float32", "cuda",
              {"radices": [64, 256], "time_us": float("inf")}, batch=4096)
    assert len(c) == 0
    c.put(16384, "float32", "cuda",
          {"radices": [128, 128], "strategy": "fused", "time_us": 5.0})
    c._entries["n=16384,precision=float32,platform=cuda,batch=4096"] = {
        "radices": [64, 256], "time_us": float("inf"), "batch": 4096}
    got = c.get(16384, "float32", "cuda", batch=4096)
    assert got is not None and got["radices"] == (128, 128)
    c._entries["n=16384,precision=float32,platform=cuda"] = {
        "radices": [64, 256], "time_us": float("nan")}
    assert c.get(16384, "float32", "cuda") is None
    with pytest.raises(ValueError):
        c.save()
    # The failed save left no temp file behind.
    assert sorted(p.name for p in tmp_path.iterdir()
                  if not p.name.endswith(".lock")) == []
    c.put(16384, "float32", "cuda",
          {"radices": [128, 128], "strategy": "fused", "time_us": 7.0},
          batch=512)
    assert c.get(16384, "float32", "cuda")["radices"] == (128, 128)
    del c._entries["n=16384,precision=float32,platform=cuda,batch=4096"]
    c.save()


def test_cache_dedupe_invariant(tmp_path):
    c = TunerCache(tmp_path / "cache.json")
    c.put(4096, "bfloat16", "cuda", {"radices": [64, 64]}, batch=4096)
    c.put(4096, "bfloat16", "cuda", {"radices": [16, 256]}, batch=512)
    c.save()
    assert len(TunerCache(tmp_path / "cache.json")) == 2
    entries = json.loads((tmp_path / "cache.json").read_text())["entries"]
    for k, v in entries.items():
        if ",batch=" in k:
            assert entries.get(k.rsplit(",batch=", 1)[0]) != v
    assert TunerCache(tmp_path / "cache.json").dedupe() == 0


def test_cache_equal_batch_retune_cannot_demote(tmp_path):
    # A slower equal-batch re-measurement demotes neither the blind entry
    # nor, unlike the JAX package's writer, the exact-batch entry.
    c = TunerCache(tmp_path / "cache.json")
    c.put(4096, "bfloat16", "cuda",
          {"radices": [32, 128], "strategy": "fused", "time_us": 260.0},
          batch=4096)
    c.put(4096, "bfloat16", "cuda",
          {"radices": [64, 64], "strategy": "fused", "time_us": 300.0},
          batch=4096)
    assert c.get(4096, "bfloat16", "cuda")["radices"] == (32, 128)
    assert c.get(4096, "bfloat16", "cuda", batch=4096)["radices"] == (32, 128)
    # A faster equal-batch retune replaces both.
    c.put(4096, "bfloat16", "cuda",
          {"radices": [64, 256], "strategy": "fused", "time_us": 250.0},
          batch=4096)
    assert c.get(4096, "bfloat16", "cuda")["radices"] == (64, 256)
    assert c.get(4096, "bfloat16", "cuda", batch=4096)["radices"] == (64, 256)


def test_slower_exact_batch_entry_does_not_replace_faster(tmp_path):
    # Exact-batch key only (the blind key is held by a larger batch), in
    # memory and across processes' saves.
    path = tmp_path / "cache.json"
    c = TunerCache(path)
    c.put(8192, "bfloat16", "cuda", {"radices": [8, 1024], "time_us": 900.0},
          batch=8192)
    c.put(8192, "bfloat16", "cuda", {"radices": [64, 128], "time_us": 100.0},
          batch=64)
    c.put(8192, "bfloat16", "cuda", {"radices": [128, 64], "time_us": 150.0},
          batch=64)
    assert c.get(8192, "bfloat16", "cuda", batch=64)["radices"] == (64, 128)
    c.save()
    fast, slow = TunerCache(path), TunerCache(path)
    slow.put(8192, "bfloat16", "cuda", {"radices": [16, 512], "time_us": 120.0},
             batch=32)
    fast.put(8192, "bfloat16", "cuda", {"radices": [32, 256], "time_us": 80.0},
             batch=32)
    fast.save()
    slow.save()  # a slower result saved later keeps the faster one on disk
    final = TunerCache(path)
    assert final.get(8192, "bfloat16", "cuda", batch=32)["radices"] == (32, 256)
    assert final.get(8192, "bfloat16", "cuda", batch=64)["radices"] == (64, 128)
    assert final.get(8192, "bfloat16", "cuda")["radices"] == (8, 1024)


def test_cache_save_merges_concurrent_writers(tmp_path):
    path = tmp_path / "cache.json"
    a = TunerCache(path)
    a.put(4096, "bfloat16", "cuda",
          {"strategy": "fused", "radices": [64, 64], "time_us": 500.0},
          batch=4096)
    a.save()
    b, c = TunerCache(path), TunerCache(path)
    b.put(8192, "bfloat16", "cuda",
          {"strategy": "fused", "radices": [64, 128], "time_us": 600.0},
          batch=4096)
    b.put(4096, "bfloat16", "cuda",
          {"strategy": "fused", "radices": [32, 128], "time_us": 400.0},
          batch=4096)
    b.save()
    # c holds the stale snapshot; its save keeps b's winners.
    c.put(16384, "bfloat16", "cuda",
          {"strategy": "fused", "radices": [64, 256], "time_us": 700.0},
          batch=4096)
    c.save()
    final = TunerCache(path)
    assert final.get(16384, "bfloat16", "cuda")["radices"] == (64, 256)
    assert final.get(8192, "bfloat16", "cuda")["radices"] == (64, 128)
    assert final.get(4096, "bfloat16", "cuda")["radices"] == (32, 128)
    d, e = TunerCache(path), TunerCache(path)
    d.put(4096, "bfloat16", "cuda",
          {"strategy": "fused", "radices": [16, 256], "time_us": 350.0},
          batch=4096)
    d.save()
    e.put(4096, "bfloat16", "cuda",
          {"strategy": "fused", "radices": [64, 64], "time_us": 380.0},
          batch=4096)
    e.save()
    entries = json.loads(path.read_text())["entries"]
    assert TunerCache(path).get(4096, "bfloat16", "cuda")["radices"] == (16, 256)
    # The exact-batch key keeps the faster result too (dedupe then drops it
    # as the blind entry's twin).
    assert TunerCache(path).get(4096, "bfloat16", "cuda",
                                batch=4096)["radices"] == (16, 256)
    assert all(v.get("time_us") != 380.0 for v in entries.values())


def test_writers_use_distinct_temp_files(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    sources = []
    real_replace = os.replace

    def spy(src, dst):
        sources.append(str(src))
        return real_replace(src, dst)

    monkeypatch.setattr(cache_mod.os, "replace", spy)
    for n in (256, 512):
        c = TunerCache(path)
        c.put(n, "bfloat16", "cuda", {"radices": [16, n // 16]})
        c.save()
    assert len(sources) == 2 and sources[0] != sources[1]
    assert all(os.path.dirname(s) == str(tmp_path) for s in sources)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cache.json",
                                                          "cache.json.lock"]


def test_concurrent_saves_keep_every_entry(tmp_path):
    # Two writers save in a loop at once: the lock serialises each
    # read-merge-write, so no writer's entry is lost and the file stays
    # valid JSON.
    path = tmp_path / "cache.json"
    errors = []

    def writer(w):
        try:
            for i in range(12):
                c = TunerCache(path)
                c.put(2 ** (i + 1), "bfloat16", f"w{w}",
                      {"radices": [2 ** (i + 1)], "time_us": float(i)})
                c.save()
        except Exception as exc:  # surfaced by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    final = TunerCache(path)
    assert len(final) == 24
    for w in range(2):
        for i in range(12):
            assert final.get(2 ** (i + 1), "bfloat16", f"w{w}") is not None


# Entries in one cache file for both packages, keyed to the CPU platform:
# (n, precision, entry, batch).  They include the planar structures the JAX
# package's TPU cache selects.
SHARED_ENTRIES = [
    (4096, "bfloat16", {"strategy": "fused", "radices": [32, 128],
                        "grouped": True, "kloop_width": 256,
                        "engine": "planar_vpu", "time_us": 260.0}, None),
    (1 << 17, "bfloat16", {"strategy": "four_step",
                           "four_step_split": [128, 1024],
                           "complex_mult": "mult3", "engine": "planar",
                           "lane_tile": 128, "time_us": 174.85}, 32),
    (1 << 23, "bfloat16", {"strategy": "four_step",
                           "four_step_split": [2048, 4096],
                           "col_radices": [64, 32], "row_radices": [64, 64],
                           "engine": "planar", "grouped": True,
                           "time_us": 946.73}, None),
    (256, "float32", {"strategy": "fused", "radices": [16, 16],
                      "first_dot": "bf16ax2", "fused_layout": "batch_major"},
     None),
]


@pytest.mark.parametrize("n,precision,batch_hint", [
    (4096, "bfloat16", None), (1 << 17, "bfloat16", 32),
    (1 << 17, "bfloat16", None), (1 << 23, "bfloat16", 2),
    (256, "float32", None), (1024, "bfloat16", None),
])
def test_tuning_auto_matches_jax(tmp_path, monkeypatch, n, precision,
                                 batch_hint):
    path = tmp_path / "shared.json"
    cache = TunerCache(path)
    for en, prec, entry, batch in SHARED_ENTRIES:
        cache.put(en, prec, "cpu", entry, batch=batch)
    cache.save()
    # The JAX package's reader takes the port's file.
    assert len(JaxTunerCache(path)) == len(cache)
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(path))
    got = tt.create_plan(n, precision=precision, tuning="auto",
                         batch_hint=batch_hint)
    want = tfft.create_plan(n, precision=precision, tuning="auto",
                            batch_hint=batch_hint)
    assert _fields(got) == _fields(want)
    tuned = any(en == n and prec == precision for en, prec, _, _ in SHARED_ENTRIES)
    assert (_fields(got) != _fields(tt.create_plan(n, precision=precision))) == tuned
    ok, why = tt.plan_works_on_device(got, "cuda")
    assert ok, why


def test_tuning_auto_reads_the_cuda_platform_on_a_card(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    cache = TunerCache(path)
    cache.put(4096, "bfloat16", "cuda", {"radices": [16, 256], "engine": "planar"})
    cache.save()
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(path))
    assert tt.create_plan(4096, tuning="auto") == tt.create_plan(4096)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    plan = tt.create_plan(4096, tuning="auto")
    assert plan.radices == (16, 256) and plan.engine == "planar"


def test_planar_knobs_work_on_device():
    # Every engine and numeric knob has a kernel on the card, the planar
    # engines under grouped/mult3 (which they ignore) and a bf16 state
    # included; a knob value FFTPlan rejects raises ValueError.
    for tuning in ({"engine": "planar"}, {"engine": "planar_vpu"},
                   {"engine": "planar", "grouped": True},
                   {"engine": "planar", "complex_mult": "mult3"},
                   {"engine": "planar", "state_dtype": "bfloat16"},
                   {"grouped": True}, {"complex_mult": "mult3"},
                   {"engine": "pretwiddle"}):
        ok, why = tt.plan_works_on_device(tt.create_plan(4096, tuning=tuning), "cuda")
        assert ok, (tuning, why)
    with pytest.raises(ValueError, match="state_dtype"):
        tt.create_plan(4096, tuning={"state_dtype": "float16"})
