"""Kernel A's pipelined persistent kernel (``csrc/fused_fft_pipe.cu``,
``fused_fft_pipe_kernel``): one kernel over tiles of T consecutive rows a
step, T = 1 (a row a step) included.

On the CPU: the rules that pick it and its T (``fused_cuda.takes_pipeline``,
``fused_cuda.pipeline_tile``), its counter names, and what
``_launch_fused`` hands the C launcher, with the launch recorded and the
card's SM count passed in.

On the card (``-m gpu``; every such test skips without a CUDA device, decided
in the ``cuda`` fixture): its outputs, at T = 1 and at every T the rule
picks, equal ``fused_fft_tc_kernel``'s bit for bit, the reference running
the same rows in chunks of at most SMs rows,
each of which takes one CTA a row, or one CTA a row forced; a view off a
16-byte boundary takes one CTA a row; the counter names the pipelined launch
and its tile exactly when the rules hold.

    python -m pytest -m gpu tests/test_torch_fused_pipe.py
"""
import collections

import numpy as np
import pytest
import torch

import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.fft import stage_scales
from tensorfft_tpu_torch.ops import fused_cuda

torch.set_num_threads(1)

SMS = 132  # the H100's SMs; the rule takes the count as an argument

# (name, knobs, runs the knob-free stacked engine); radices (128, 128).
ENGINES = [
    ("stacked", {}, True),
    ("pretwiddle", dict(engine="pretwiddle"), True),
    ("planar", dict(engine="planar"), False),
    ("grouped", dict(grouped=True), False),
    ("bf16_state", dict(state_dtype="bfloat16"), False),
]
RADICES = (128, 128)


def _stages(knobs):
    return fused_cuda.pass_stages(RADICES, knobs.get("engine", "stacked"),
                                  knobs.get("grouped", False),
                                  knobs.get("complex_mult", "block"),
                                  knobs.get("state_dtype", "float32"))


def _want_variant(name, knobs, pipelined, cluster):
    tags = [] if name in ("stacked", "grouped", "bf16_state") else [name]
    tags += ["grouped"] if knobs.get("grouped") else []
    tags += ["bf16_state"] if knobs.get("state_dtype") == "bfloat16" else []
    tags += ["pipelined"] if pipelined else []
    return ",".join(tags + ["mma" if cluster == 1 else f"cluster{cluster}"])


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("name,knobs,knob_free", ENGINES,
                         ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("dtype,algorithm", [(torch.bfloat16, "bf16"),
                                             (torch.float32, "bf16x3")],
                         ids=["bf16", "float32"])
@pytest.mark.parametrize("batch", [1, SMS, SMS + 1, 4096])
def test_selection_rule_and_variant(batch, dtype, algorithm, name, knobs,
                                    knob_free, cluster, aligned):
    stages = _stages(knobs)
    state = knobs.get("state_dtype", "float32")
    assert fused_cuda.knob_free(knobs.get("engine", "stacked"), stages,
                                state) == knob_free
    pointers = [1 << 20, 3 << 20, 5 << 20, (7 << 20) + (0 if aligned else 2)]
    got = fused_cuda.takes_pipeline(
        dtype=dtype, algorithm=algorithm, engine=knobs.get("engine", "stacked"),
        stages=stages, state_dtype=state, cluster=cluster, batch=batch,
        n=16384, pointers=pointers, sms=SMS)
    want = (dtype is torch.bfloat16 and knob_free and cluster == 1 and aligned
            and batch > SMS)
    assert got == want
    variant = fused_cuda.variant(knobs.get("engine", "stacked"), stages, state,
                                 cluster, got)
    assert variant == _want_variant(name, knobs, want, cluster)
    assert (variant == "pipelined,mma") == (want and name == "stacked")


@pytest.mark.parametrize("n,want", [(16384, True), (512, True), (1000, False),
                                    (768, False), (1004, False), (256, True),
                                    (128, True), (384, False), (64, False),
                                    (8, False)])
def test_selection_rule_takes_powers_of_two_from_128(n, want):
    # The pipelined kernel takes the lengths a plan makes, powers of two, from
    # 128 (below, tiles of rows did not beat one CTA a row) to 16384.
    assert fused_cuda.takes_pipeline(
        dtype=torch.bfloat16, algorithm="bf16ax2", engine="stacked",
        stages=_stages({}), state_dtype="float32", cluster=1, batch=SMS + 1,
        n=n, pointers=[0, 16, 32, 48], sms=SMS) == want


# The pipelined kernel's T by length at a large batch: a tile of 16384
# elements from n = 2048 on, 8192 below; 1 at 16384.
TILE = {128: 64, 256: 32, 512: 16, 1024: 8, 2048: 8, 4096: 4, 8192: 2,
        16384: 1}


def _want_tile(n, batch, sms):
    """T at n and batch: TILE's, halved while the batch still gives at most
    ``sms`` tiles; 1 off the table and at batch <= sms."""
    t = TILE.get(n, 1)
    while t > 1 and -(-batch // (t // 2)) <= sms:
        t //= 2
    return t


@pytest.mark.parametrize("sms", [SMS, 114], ids=["sms132", "sms114"])
@pytest.mark.parametrize("rows", ["sms", "sms_plus_1", "sms_tiles",
                                  "sms_tiles_plus_1", "undivided", "4096",
                                  "262144"])
@pytest.mark.parametrize("n", sorted(TILE) + [64, 1000, 2056])
def test_tile_rule(n, rows, sms):
    t = TILE.get(n, 1)
    batch = {"sms": sms, "sms_plus_1": sms + 1, "sms_tiles": sms * t,
             "sms_tiles_plus_1": sms * t + 1,
             "undivided": (sms + 7) * t + t // 2 + 1, "4096": 4096,
             "262144": 262144}[rows]
    got = fused_cuda.pipeline_tile(n, batch, sms)
    assert got == _want_tile(n, batch, sms)
    if n not in TILE or n == 16384 or batch <= sms:
        assert got == 1
    elif -(-batch // t) > sms:
        # More tiles than SMs: the tile of the length.
        assert got == t
        assert rows not in ("sms", "sms_tiles")
    else:
        # At most SMs tiles: halved to the most tiles that still fit, never
        # to a row a step.
        assert 2 <= got <= t and -(-batch // got) <= sms
        assert got == 2 or -(-batch // (got // 2)) > sms


@pytest.mark.parametrize("n,batch,want", [
    (512, 262144, 16),   # the 512^3 grid's axis 0
    (512, 4096, 16), (1024, 4096, 8), (2048, 4096, 8), (4096, 4096, 4),
    (8192, 4096, 2), (256, 4096, 32), (128, 4096, 32),
    (4096, 256, 2),      # the entry flagship: 128 tiles of 2 rows
    (512, 1024, 8), (512, SMS + 1, 2), (16384, 4096, 1), (1000, 4096, 1),
    (512, SMS, 1)])
def test_tile_rule_at_named_shapes(n, batch, want):
    assert fused_cuda.pipeline_tile(n, batch, SMS) == want


def test_tile_variant_names():
    stages = _stages({})
    assert fused_cuda.variant("stacked", stages, "float32", 1, True, 16) == \
        "pipelined,tile16,mma"
    assert fused_cuda.variant("stacked", stages, "float32", 1, True, 1) == \
        "pipelined,mma"
    assert fused_cuda.variant("pretwiddle", stages, "float32", 1, True, 4) == \
        "pretwiddle,pipelined,tile4,mma"
    # A tile names only a pipelined launch.
    assert fused_cuda.variant("stacked", stages, "float32", 1, False, 32) == "mma"


@pytest.fixture
def recorded(monkeypatch):
    """Record the C launch (symbol, codes, arguments) and give CPU tensors
    the card's SM count."""
    calls = []
    monkeypatch.setattr(fused_cuda, "launch",
                        lambda symbol, tensors, codes, *args:
                        calls.append((symbol, codes, args)))
    monkeypatch.setattr(fused_cuda, "multiprocessors", lambda device: SMS)
    return calls


@pytest.mark.parametrize("pipelined", [None, False], ids=["rule", "forced_off"])
@pytest.mark.parametrize("batch", [SMS, SMS + 1])
def test_launch_passes_the_choice(recorded, batch, pipelined):
    re = torch.zeros(batch, 1024, dtype=torch.bfloat16)
    kw = dict(radices=(32, 32), scales=(1 / 32, 1 / 32), sign=-1, algorithm="bf16",
              first_dot="default", engine="stacked", grouped=False,
              complex_mult="block", state_dtype="float32")
    before = collections.Counter(fused_cuda.fused_fft.variant_launches)
    fused_cuda._launch_fused(re, re.clone(), pipelined=pipelined, **kw)
    (symbol, codes, args), = recorded
    assert symbol == "tfft_fused_fft" and codes == (0, 1)
    on = pipelined is None and batch > SMS
    # batch, n, cluster, the SMs the pipelined kernel walks (0: off), then
    # its rows a step (SMS + 1 rows of 1024: tiles of 2, 67 of them).
    assert args[:5] == (batch, 1024, 1, SMS if on else 0, 2 if on else 1)
    launched = collections.Counter(fused_cuda.fused_fft.variant_launches) - before
    assert launched == {"pipelined,tile2,mma" if on else "mma": 1}


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("rows", ["sms", "sms_plus_1", "sms_tiles",
                                  "sms_tiles_plus_1", "undivided"])
@pytest.mark.parametrize("n", sorted(TILE))
def test_launch_passes_the_tile(recorded, n, rows, aligned):
    t = TILE[n]
    batch = {"sms": SMS, "sms_plus_1": SMS + 1, "sms_tiles": SMS * t,
             "sms_tiles_plus_1": SMS * t + 1,
             "undivided": (SMS + 3) * t + max(t // 2, 1) + 1}[rows]
    offset = 0 if aligned else 1
    flat = torch.zeros(2, batch * n + offset, dtype=torch.bfloat16)
    re, im = (p[offset:].view(batch, n) for p in flat)
    plan = tt.create_plan(n)
    kw = dict(radices=plan.radices, sign=-1,
              scales=stage_scales(plan.radices, "forward", True),
              algorithm="bf16", first_dot=plan.first_dot, engine="stacked",
              grouped=False, complex_mult="block", state_dtype="float32")
    before = collections.Counter(fused_cuda.fused_fft.variant_launches)
    fused_cuda._launch_fused(re, im, **kw)
    (symbol, codes, args), = recorded
    assert symbol == "tfft_fused_fft" and codes == (0, 1)
    on = aligned and batch > SMS
    tile = _want_tile(n, batch, SMS) if on else 1
    assert args[:5] == (batch, n, 1, SMS if on else 0, tile)
    launched = collections.Counter(fused_cuda.fused_fft.variant_launches) - before
    want = "mma" if not on else (
        f"pipelined,tile{tile},mma" if tile > 1 else "pipelined,mma")
    assert launched == {want: 1}
    if on and rows in ("sms_tiles_plus_1", "undivided"):
        assert tile == t
    if on and n < 16384:
        assert tile >= 2


@pytest.mark.parametrize("tile", [None, 1, 32])
def test_launch_passes_a_forced_tile(recorded, tile):
    # tile overrides the rule on a pipelined call; one CTA a row ignores it.
    batch, n = SMS * 16 + 1, 512
    re = torch.zeros(batch, n, dtype=torch.bfloat16)
    kw = dict(radices=(16, 32), scales=(1 / 16, 1 / 32), sign=-1,
              algorithm="bf16", first_dot="bf16ax2", engine="stacked",
              grouped=False, complex_mult="block", state_dtype="float32")
    fused_cuda._launch_fused(re, re.clone(), tile=tile, **kw)
    fused_cuda._launch_fused(re, re.clone(), pipelined=False, tile=tile, **kw)
    (_, _, on), (_, _, off) = recorded
    assert on[:5] == (batch, n, 1, SMS, 16 if tile is None else tile)
    assert off[:5] == (batch, n, 1, 0, 1)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _planes(b, n, device, seed, offset=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, b * n + offset), dtype=np.float32)
    return [torch.from_numpy(p).to(device, torch.bfloat16)[offset:].view(b, n)
            for p in x]


def _kwargs(n, forward):
    radices = tt.create_plan(n).radices
    return dict(radices=radices, sign=-1 if forward else 1,
                scales=stage_scales(radices, "forward", forward))


def _plan_kwargs(n, forward):
    """_kwargs with the plan's own dot algorithm and first stage (bf16ax2 at
    n <= 1024)."""
    plan = tt.create_plan(n)
    return dict(_kwargs(n, forward), algorithm=plan.precision.dot_algorithm,
                first_dot=plan.first_dot)


def _launched(call):
    before = collections.Counter(fused_cuda.fused_fft.variant_launches)
    out = call()
    torch.cuda.synchronize()
    return out, dict(collections.Counter(fused_cuda.fused_fft.variant_launches)
                     - before)


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("extra", [1, 4096, 4099], ids=lambda e: f"b{e}")
@pytest.mark.parametrize("n", [256, 4096, 16384])
def test_pipelined_equals_one_cta_a_row(cuda, n, extra, forward):
    # b = SMs + 1, 4096, 4099: 4099 leaves the CTAs unequal row counts.  Below
    # n = 16384 the rule takes tiles of rows, and a row a step (T = 1), which
    # the rule keeps off those lengths, is forced too.
    sms = fused_cuda.multiprocessors(cuda)
    b = sms + 1 if extra == 1 else extra
    re, im = _planes(b, n, cuda, seed=n + b + forward)
    kw = _kwargs(n, forward)
    tile = _want_tile(n, b, sms)
    assert (tile > 1) == (n < 16384)
    got, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    assert launched == {(f"pipelined,tile{tile},mma" if tile > 1
                         else "pipelined,mma"): 1}
    chunks = [range(s, min(s + sms, b)) for s in range(0, b, sms)]
    want, launched = _launched(lambda: [
        torch.cat(parts) for parts in zip(*(
            fused_cuda.fused_fft(re[c.start:c.stop], im[c.start:c.stop], **kw)
            for c in chunks))])
    assert launched == {"mma": len(chunks)}
    _bitwise(got, want)
    if tile > 1:
        full = dict(kw, algorithm="bf16", first_dot="default", engine="stacked",
                    grouped=False, complex_mult="block", state_dtype="float32")
        row, launched = _launched(lambda: fused_cuda._launch_fused(
            re, im, pipelined=True, tile=1, **full))
        assert launched == {"pipelined,mma": 1}
        _bitwise(row, want)


@pytest.mark.gpu
def test_offset_rows_take_one_cta_a_row(cuda):
    sms = fused_cuda.multiprocessors(cuda)
    b, n = sms + 5, 4096
    re, im = _planes(b, n, cuda, seed=5, offset=1)
    assert re.data_ptr() % 16 and im.data_ptr() % 16
    kw = _kwargs(n, True)
    got, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    assert launched == {"mma": 1}
    want, launched = _launched(
        lambda: fused_cuda.fused_fft(re.clone(), im.clone(), **kw))
    assert launched == {f"pipelined,tile{_want_tile(n, b, sms)},mma": 1}
    _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,knobs,knob_free", ENGINES,
                         ids=[e[0] for e in ENGINES])
@pytest.mark.parametrize("more", [0, 1], ids=["sms", "sms_plus_1"])
def test_counter_names_the_pipelined_launch(cuda, more, name, knobs, knob_free):
    sms = fused_cuda.multiprocessors(cuda)
    b = sms + more
    re, im = _planes(b, 16384, cuda, seed=b)
    kw = dict(radices=RADICES, scales=stage_scales(RADICES, "forward", True),
              **knobs)
    _, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    on = knob_free and b > sms
    assert launched == {_want_variant(name, knobs, on, 1): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("rows", ["sms_plus_1", "sms_tiles_plus_1", "undivided",
                                  "4096"])
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096, 8192])
def test_tile_equals_one_cta_a_row(cuda, n, rows, forward):
    # SMs + 1 rows: tiles of 2, the last of one row; SMs * T + 1: one tile
    # more than SMs, the last of one row; the undivided batch ends in a tile
    # of T / 2 + 1 rows.  The plan's own first stage (bf16ax2 at n <= 1024).
    sms = fused_cuda.multiprocessors(cuda)
    t = TILE[n]
    b = {"sms_plus_1": sms + 1, "sms_tiles_plus_1": sms * t + 1,
         "undivided": (sms + 3) * t + t // 2 + 1, "4096": 4096}[rows]
    re, im = _planes(b, n, cuda, seed=n + b + forward)
    kw = _plan_kwargs(n, forward)
    got, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    tile = _want_tile(n, b, sms)
    if rows == "sms_plus_1":
        assert tile == 2
    elif rows != "4096":
        assert tile == t
    assert launched == {f"pipelined,tile{tile},mma": 1}
    full = dict(kw, engine="stacked", grouped=False, complex_mult="block",
                state_dtype="float32")
    want, launched = _launched(
        lambda: fused_cuda._launch_fused(re, im, pipelined=False, **full))
    assert launched == {"mma": 1}
    _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_tile_equals_one_cta_a_row_at_the_grid_rows(cuda, forward):
    # The 512^3 grid's axis-0 call: 262,144 rows of 512, bf16ax2 first stage;
    # also the whole-CTA tile (T = 32) and a row a step (T = 1) forced.
    n, b = 512, 262144
    re, im = _planes(b, n, cuda, seed=7 + forward)
    kw = _plan_kwargs(n, forward)
    assert kw["first_dot"] == "bf16ax2"
    got, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    assert launched == {"pipelined,tile16,mma": 1}
    full = dict(kw, engine="stacked", grouped=False, complex_mult="block",
                state_dtype="float32")
    want, launched = _launched(
        lambda: fused_cuda._launch_fused(re, im, pipelined=False, **full))
    assert launched == {"mma": 1}
    _bitwise(got, want)
    for tile, name in ((32, "pipelined,tile32,mma"), (1, "pipelined,mma")):
        out, launched = _launched(lambda: fused_cuda._launch_fused(
            re, im, pipelined=True, tile=tile, **full))
        assert launched == {name: 1}
        _bitwise(out, want)


@pytest.mark.gpu
def test_offset_rows_take_one_cta_a_row_not_a_tile(cuda):
    sms = fused_cuda.multiprocessors(cuda)
    n = 512
    b = sms * TILE[n] + 5
    re, im = _planes(b, n, cuda, seed=11, offset=1)
    assert re.data_ptr() % 16 and im.data_ptr() % 16
    kw = _plan_kwargs(n, True)
    got, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    assert launched == {"mma": 1}
    want, launched = _launched(
        lambda: fused_cuda.fused_fft(re.clone(), im.clone(), **kw))
    assert launched == {"pipelined,tile16,mma": 1}
    _bitwise(got, want)
