"""Kernel A's pipelined persistent kernel (``csrc/fused_fft_pipe.cu``,
``fused_fft_pipe_kernel``): one kernel over tiles of T consecutive rows a
step, T = 1 (a row a step) included.

On the CPU: the rules that pick it and its T (``fused_cuda.takes_pipeline``,
``fused_cuda.pipeline_tile``), its counter names, and what
``_launch_fused`` hands the C launcher, with the launch recorded and the
card's SM count passed in; for the strided landing of an N-D pass
(``fused_cuda.fused_fft_columns``, ``fused_fft_pipe_cols_kernel``), the
rule (``fused_cuda.column_tile``), what ``_launch_columns`` hands its C
launcher, and the CPU version; the roots route (a two-term stage of radix
256 on tiles of T > 1 rows gathers its fragments from the stage's roots:
``fused_cuda.roots_route``, ``roots_stage``), its counter name
(``...,roots,mma``).

On the card (``-m gpu``; every such test skips without a CUDA device, decided
in the ``cuda`` fixture): its outputs, at T = 1 and at every T the rule
picks, equal ``fused_fft_tc_kernel``'s bit for bit, the reference running
the same rows in chunks of at most SMs rows,
each of which takes one CTA a row, or one CTA a row forced; a view off a
16-byte boundary takes one CTA a row; the counter names the pipelined launch
and its tile exactly when the rules hold.  An N-D pass that the rule lands
from the strided planes equals the relayout's pass bit for bit, with the
same strides, and copies nothing; every other pass takes the relayout.  The
roots route equals one CTA a row bit for bit at the Poisson solve's 262,144
rows of 256 and under every warp blocking.

    python -m pytest -m gpu tests/test_torch_fused_pipe.py
"""
import collections
import importlib
import math

import numpy as np
import pytest
import torch

import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch import tracing
from tensorfft_tpu_torch.fft import stage_scales
from tensorfft_tpu_torch.ops import fused_cuda

torch.set_num_threads(1)

fft_module = importlib.import_module("tensorfft_tpu_torch.fft")

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


def _keep_counts(monkeypatch):
    """Count the fake launches on copies of the wrappers' counters, so the
    process's counts are as they were after the test."""
    for wrapper in (fused_cuda.fused_fft, fused_cuda.fused_fft_columns):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
        monkeypatch.setattr(wrapper, "variant_launches",
                            collections.Counter(wrapper.variant_launches))


@pytest.fixture
def recorded(monkeypatch):
    """Record the C launch (symbol, codes, arguments) and give CPU tensors
    the card's SM count."""
    calls = []
    _keep_counts(monkeypatch)
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
    # The default plan's one radix-256 stage at n = 256 (bf16ax2) gathers
    # its A fragments from its roots on tiles of T > 1 rows.
    roots = ",roots" if n == 256 else ""
    want = "mma" if not on else (
        f"pipelined,tile{tile}{roots},mma" if tile > 1 else "pipelined,mma")
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


# -- the roots route: a two-term stage of radix 256 on tiles of T > 1 rows ---

def _meta(radices, algorithm="bf16", first_dot="bf16ax2"):
    scales = tuple(float(s) for s in stage_scales(radices, "forward", True))
    return fused_cuda.kernel_tables(tuple(radices), scales, -1, algorithm,
                                    first_dot, torch.device("cpu"))[1]


@pytest.mark.parametrize("radix,terms,want", [
    (128, 2, False), (256, 2, True), (512, 2, False), (4096, 2, False),
    (8192, 2, False), (128, 1, False), (256, 1, False)])
def test_roots_rule(radix, terms, want):
    assert fused_cuda.roots_route(radix, terms) == want
    # A folded stage takes the vector route, never the roots.
    assert not fused_cuda.roots_route(radix, terms, fused_cuda._STACKED_FOLDED)


@pytest.mark.parametrize("radices,algorithm,first_dot,want", [
    ((256,), "bf16", "bf16ax2", 0),       # the default plan at 256
    ((256,), "bf16", "default", None),    # one term
    ((128,), "bf16", "bf16ax2", None),    # the default plan at 128
    ((16, 32), "bf16", "bf16ax2", None),  # the default plan at 512
    ((4, 256), "bf16ax2", "default", 1),
    ((4, 256), "bf16", "bf16ax2", None),  # its radix-256 stage has one term
    ((256, 4), "bf16", "bf16ax2", 0),
    ((512,), "bf16", "bf16ax2", None),    # only the radix measured
    ((4, 512), "bf16ax2", "default", None),
], ids=["256", "256_one_term", "128", "16x32", "4x256", "4x256_one_term",
        "256x4", "512", "4x512"])
def test_roots_stage_of_a_pass(radices, algorithm, first_dot, want):
    meta = _meta(radices, algorithm, first_dot)
    for tile in (2, 8, 32):
        assert fused_cuda.roots_stage(meta, tile) == want
    assert fused_cuda.roots_stage(meta, 1) is None  # a row a step: never


def test_roots_variant_names():
    stages = _stages({})
    assert fused_cuda.variant("stacked", stages, "float32", 1, True, 32,
                              roots=True) == "pipelined,tile32,roots,mma"
    assert fused_cuda.variant("stacked", stages, "float32", 1, True, 16,
                              columns=True, roots=True) == \
        "pipelined,tile16,cols,roots,mma"
    assert fused_cuda.variant("stacked", stages, "float32", 1, True, 16,
                              columns=True) == "pipelined,tile16,cols,mma"
    assert fused_cuda.variant("stacked", stages, "float32", 1, True, 1) == \
        "pipelined,mma"
    # The roots name only a pipelined launch.
    assert fused_cuda.variant("stacked", stages, "float32", 1, False, 1,
                              roots=True) == "mma"


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_launch_counts_the_roots_at_the_solves_tiles(recorded, forward):
    # rfft_split's transform in the solve: the default plan at 256 (bf16ax2)
    # on tiles of 32 rows; a row a step and one CTA a row read the table.
    batch = SMS * 32 + 1
    re = torch.zeros(batch, 256, dtype=torch.bfloat16)
    kw = dict(_plan_kwargs(256, forward), engine="stacked", grouped=False,
              complex_mult="block", state_dtype="float32")
    before = collections.Counter(fused_cuda.fused_fft.variant_launches)
    fused_cuda._launch_fused(re, re.clone(), **kw)
    fused_cuda._launch_fused(re, re.clone(), pipelined=True, tile=1, **kw)
    fused_cuda._launch_fused(re, re.clone(), pipelined=False, **kw)
    assert [args[:5] for _, _, args in recorded] == [
        (batch, 256, 1, SMS, 32), (batch, 256, 1, SMS, 1), (batch, 256, 1, 0, 1)]
    launched = collections.Counter(fused_cuda.fused_fft.variant_launches) - before
    assert launched == {"pipelined,tile32,roots,mma": 1, "pipelined,mma": 1,
                        "mma": 1}


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
    roots = ",roots" if n == 256 else ""  # the one radix-256 stage, bf16ax2
    assert launched == {f"pipelined,tile{tile}{roots},mma": 1}
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
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_roots_equal_one_cta_a_row_at_the_solves_rows(cuda, forward):
    # rfft_split's transform in the 512^3 solve: 262,144 rows of 256, the
    # default plan's one radix-256 stage (bf16ax2), its A fragments gathered
    # from the stage's roots; one CTA a row reads them from the table.
    n, b = 256, 262144
    re, im = _planes(b, n, cuda, seed=21 + forward)
    kw = _plan_kwargs(n, forward)
    assert kw["radices"] == (256,) and kw["first_dot"] == "bf16ax2"
    got, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    assert launched == {"pipelined,tile32,roots,mma": 1}
    full = dict(kw, engine="stacked", grouped=False, complex_mult="block",
                state_dtype="float32")
    want, launched = _launched(
        lambda: fused_cuda._launch_fused(re, im, pipelined=False, **full))
    assert launched == {"mma": 1}
    _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("radices,algorithm,first_dot,tiles", [
    ((256,), "bf16", "bf16ax2", (64, 32, 16, 8, 4, 2)),
    ((4, 256), "bf16ax2", "default", (16, 8, 2)),
    ((256, 4), "bf16", "bf16ax2", (16, 8, 2)),
], ids=["256", "4x256", "256x4"])
def test_roots_equal_one_cta_a_row_at_every_tile(cuda, radices, algorithm,
                                                  first_dot, tiles, forward):
    # Every route of stage_mma_roots: the warp blockings (4, 4), (2, 4) and
    # (2, 2), and stage_mma's tile order (T <= 8, under 8 columns a row tile
    # at T < 8); the radix-256 stage first or after a twiddle.
    sms = fused_cuda.multiprocessors(cuda)
    n, b = math.prod(radices), sms * tiles[0] + 3
    re, im = _planes(b, n, cuda, seed=n + len(radices) + forward)
    full = dict(radices=radices, sign=-1 if forward else 1,
                scales=stage_scales(radices, "forward", forward),
                algorithm=algorithm, first_dot=first_dot, engine="stacked",
                grouped=False, complex_mult="block", state_dtype="float32")
    want, launched = _launched(
        lambda: fused_cuda._launch_fused(re, im, pipelined=False, **full))
    assert launched == {"mma": 1}
    for tile in tiles:
        got, launched = _launched(lambda: fused_cuda._launch_fused(
            re, im, pipelined=True, tile=tile, **full))
        assert launched == {f"pipelined,tile{tile},roots,mma": 1}
        _bitwise(got, want)


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


# -- the strided landing (fused_fft_columns) ------------------------------------

def _dense_strides(shape):
    out, step = [], 1
    for size in reversed(shape):
        out.append(step)
        step *= size
    return tuple(reversed(out))


def _column_rule(shape, axis, *, dtype=torch.bfloat16, strides=None,
                 pointers=(1 << 20, 3 << 20), sms=SMS, **knobs):
    n = shape[axis]
    radices = tt.create_plan(n).radices if n & (n - 1) == 0 else (n,)
    kw = dict(radices=radices, algorithm="bf16ax2")
    kw.update(knobs)
    strides = strides or _dense_strides(shape)
    return fused_cuda.column_tile(shape, (strides, strides), axis, dtype,
                                  pointers, sms, **kw)


@pytest.mark.parametrize("shape,axis,want", [
    ((512, 512, 512), 0, 16),       # the 512^3 grid's axis 0
    ((1, 512, 512, 512), 1, 16),    # the benchmark's (rows, *grid) view
    ((3, 512, 64, 64), 1, 16),      # outer > 1
    ((128, 4096), 0, 32), ((1024, 64, 64), 0, 8), ((2048, 4096), 0, 8),
    ((256, 8, 4096), 0, 32),
    ((4096, 4096), 0, 0),           # T = 4: runs of 8 bytes
    ((8192, 256), 0, 0),            # T = 2
    ((16384, 1024), 0, 0),          # T = 1
    ((512, 4100), 0, 0),            # T = 16 does not divide 4100
    ((512, 4104), 0, 0),            # nor 4104 (8 does, but the rule says 16)
    ((512, 64), 0, 0),              # 64 lines: no more than SMs
    ((1000, 4096), 0, 0),           # not a power of two
    ((64, 4096), 0, 0),             # below TILE_MIN_N
    ((4096, 512), 1, 0), ((4096, 512), -1, 0),  # the last axis: nothing to land
    ((2, 2, 512), 2, 0),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_column_tile_rule(shape, axis, want):
    assert _column_rule(shape, axis) == want
    if want:
        n = shape[axis]
        assert want == fused_cuda.pipeline_tile(n, math.prod(shape) // n, SMS)


def test_column_tile_follows_the_sms():
    # 1024 lines of 512: on 132 SMs tiles of 8 (128 tiles of 16 would leave
    # SMs idle), on 114 SMs tiles of 16 (64 tiles of 8 would).
    assert _column_rule((512, 1024), 0, sms=SMS) == 8
    assert _column_rule((512, 1024), 0, sms=114) == 16
    assert _column_rule((512, 1024), 0, sms=1024) == 0


@pytest.mark.parametrize("case", ["float32", "gap", "transposed", "offset_re",
                                  "offset_im", "planar", "bf16_state",
                                  "grouped", "bf16x3"])
def test_column_tile_refuses(case):
    shape = (512, 4096)
    assert _column_rule(shape, 0) == 16
    kw = {"float32": dict(dtype=torch.float32),
          "gap": dict(strides=(8192, 1)),
          "transposed": dict(strides=(1, 512)),
          "offset_re": dict(pointers=((1 << 20) + 2, 3 << 20)),
          "offset_im": dict(pointers=(1 << 20, (3 << 20) + 8)),
          "planar": dict(engine="planar"),
          "bf16_state": dict(state_dtype="bfloat16"),
          "grouped": dict(grouped=True, radices=(16, 32)),
          "bf16x3": dict(algorithm="bf16x3")}[case]
    assert _column_rule(shape, 0, **kw) == 0


def test_column_tile_reads_each_plane():
    # One plane laid out otherwise than the other refuses the landing.
    shape = (512, 4096)
    plan = tt.create_plan(512)
    dense = _dense_strides(shape)
    for strides in ((dense, (8192, 1)), ((8192, 1), dense)):
        assert fused_cuda.column_tile(
            shape, strides, 0, torch.bfloat16, (0, 16), SMS,
            radices=plan.radices, algorithm="bf16") == 0


def test_dense_matches_is_contiguous():
    x = torch.zeros(4, 1, 6, 8)
    for view in (x, x[:, :, ::2], x.transpose(2, 3), x[:, :, :, :4],
                 x.expand(4, 3, 6, 8), x[1:2], x.view(4, 6, 8)[:, :1]):
        assert fused_cuda._dense(view.shape, view.stride()) == view.is_contiguous()


def _column_kwargs(n, forward=True):
    plan = tt.create_plan(n)
    return dict(radices=plan.radices, sign=-1 if forward else 1,
                scales=stage_scales(plan.radices, "forward", forward),
                algorithm=plan.precision.dot_algorithm, first_dot=plan.first_dot,
                engine="stacked", grouped=False, complex_mult="block",
                state_dtype="float32")


@pytest.fixture
def recorded_planes(monkeypatch):
    """Record the C launch with its planes' pointers, and give CPU tensors
    the card's SM count."""
    calls = []
    _keep_counts(monkeypatch)
    monkeypatch.setattr(fused_cuda, "launch",
                        lambda symbol, tensors, codes, *args: calls.append(
                            (symbol, [t.data_ptr() for t in tensors],
                             [tuple(t.shape) for t in tensors], codes, args)))
    monkeypatch.setattr(fused_cuda, "multiprocessors", lambda device: SMS)
    return calls


@pytest.mark.parametrize("shape,axis,tile", [((3, 512, 64, 64), 1, 16),
                                             ((512, 512, 64), 0, 16),
                                             ((128, 4096), 0, 32),
                                             ((2, 1024, 64, 16), 1, 8),
                                             ((2, 256, 64, 16), 1, 16)])
def test_launch_columns_passes_the_landing(recorded_planes, shape, axis, tile):
    re = torch.zeros(shape, dtype=torch.bfloat16)
    im = torch.zeros(shape, dtype=torch.bfloat16)
    n = shape[axis]
    outer, inner = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    before = collections.Counter(fused_cuda.fused_fft_columns.variant_launches)
    before_rows = fused_cuda.fused_fft.launches
    out_re, out_im = fused_cuda._launch_columns(re, im, axis, **_column_kwargs(n))
    (symbol, pointers, shapes, codes, args), = recorded_planes
    assert symbol == "tfft_fused_fft_cols" and codes == (0, 1)
    assert pointers == [re.data_ptr(), im.data_ptr(), out_re.data_ptr(),
                        out_im.data_ptr()]
    # The planes as given; the output as (outer * inner, n) rows.
    assert shapes == [shape, shape, (outer * inner, n), (outer * inner, n)]
    # outer, n, inner: the tensor map's dimensions (innermost first: inner,
    # n, outer), the card's SMs, then the lines a tile, then the tables,
    # the bf16 matrices and the meta.
    assert args[:5] == (outer, n, inner, SMS, tile)
    assert len(args) == 8
    assert len(pointers) + len(codes) + len(args) + 1 == len(
        fused_cuda._build._SIGNATURES[symbol])
    launched = (collections.Counter(fused_cuda.fused_fft_columns.variant_launches)
                - before)
    roots = ",roots" if n == 256 else ""  # the one radix-256 stage, bf16ax2
    assert launched == {f"pipelined,tile{tile},cols{roots},mma": 1}
    assert fused_cuda.fused_fft.launches == before_rows


def test_launch_columns_refuses_what_the_rule_refuses(recorded_planes):
    re = torch.zeros(512, 4100, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="column_tile"):
        fused_cuda._launch_columns(re, re.clone(), 0, **_column_kwargs(512))
    assert recorded_planes == []


@pytest.mark.parametrize("tile", [8, 32])
def test_launch_columns_passes_a_forced_tile(recorded_planes, tile):
    re = torch.zeros(512, 4096, dtype=torch.bfloat16)
    fused_cuda._launch_columns(re, re.clone(), 0, tile=tile, **_column_kwargs(512))
    (_, _, _, _, args), = recorded_planes
    assert args[:5] == (1, 512, 4096, SMS, tile)


def test_column_variant_names():
    stages = _stages({})
    assert fused_cuda.variant("stacked", stages, "float32", 1, True, 16,
                              columns=True) == "pipelined,tile16,cols,mma"
    assert fused_cuda.variant("pretwiddle", stages, "float32", 1, True, 32,
                              columns=True) == "pretwiddle,pipelined,tile32,cols,mma"


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape,axis", [((128, 6, 4), 0), ((2, 256, 3, 8), 1),
                                        ((4, 128, 16), -2)])
def test_columns_on_the_cpu_are_the_moved_rows(shape, axis, forward):
    # CPU planes: the move, the copy and the plain kernel A, in the moved
    # shape, contiguous.
    rng = np.random.default_rng(sum(shape) + forward)
    re, im = (torch.from_numpy(p).to(torch.bfloat16)
              for p in rng.standard_normal((2, *shape), dtype=np.float32))
    n = shape[axis]
    kw = _column_kwargs(n, forward)
    before = fused_cuda.fused_fft_columns.launches
    got = fused_cuda.fused_fft_columns(re, im, axis, **kw)
    rows = [torch.movedim(p, axis, -1).contiguous() for p in (re, im)]
    want = fused_cuda.fused_fft(rows[0].reshape(-1, n), rows[1].reshape(-1, n), **kw)
    for g, w, r in zip(got, want, rows):
        assert g.shape == r.shape and g.is_contiguous()
        assert torch.equal(g.reshape(-1, n), w)
    assert fused_cuda.fused_fft_columns.launches == before


def test_columns_check_their_planes():
    re = torch.zeros(128, 8, dtype=torch.bfloat16)
    kw = _column_kwargs(128)
    with pytest.raises(ValueError, match="differ"):
        fused_cuda.fused_fft_columns(re, torch.zeros(128, 4, dtype=torch.bfloat16),
                                     0, **kw)
    with pytest.raises(ValueError, match="multiply"):
        fused_cuda.fused_fft_columns(re, re, 0, **_column_kwargs(256))


# -- the strided landing on the card --------------------------------------------

def _nd_counts():
    return dict(tracing.counters()["nd"])


def _grid_planes(shape, device, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for _ in range(2)]


def _relayout_pass(re, im, axis, plan, forward):
    """The pass as the relayout runs it: the axis moved last, copied to
    contiguous (B, N) rows, kernel A, and the axis moved back."""
    rows = [torch.movedim(p, axis, -1).to(plan.precision.storage_dtype).contiguous()
            for p in (re, im)]
    out = (tt.fft_split if forward else tt.ifft_split)(*rows, plan)
    return [torch.movedim(p, -1, axis) for p in out]


def _pass_counted(call):
    """(output, nd counter deltas, kernel A's variant launches, the strided
    landing's variant launches)."""
    nd = _nd_counts()
    rows = collections.Counter(fused_cuda.fused_fft.variant_launches)
    cols = collections.Counter(fused_cuda.fused_fft_columns.variant_launches)
    out = call()
    torch.cuda.synchronize()
    after = _nd_counts()
    return (out, {k: after[k] - nd[k] for k in after},
            dict(collections.Counter(fused_cuda.fused_fft.variant_launches) - rows),
            dict(collections.Counter(fused_cuda.fused_fft_columns.variant_launches)
                 - cols))


def _same_bits_and_strides(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.stride() == w.stride()
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape,axis,tile", [
    ((512, 512, 512), 0, 16),        # the 512^3 grid's axis 0
    ((3, 512, 64, 64), 1, 16),       # outer > 1
    ((128, 64, 64), 0, 32),
    ((1024, 64, 64), 0, 8),
    ((2048, 32, 64), 0, 8),
    ((256, 512, 64), 0, 32),         # N = 256: the stage's roots, both ways
    ((2, 256, 64, 16), 1, 16),
], ids=["grid512", "outer3", "n128", "n1024", "n2048", "n256", "n256_axis1"])
def test_columns_equal_the_relayout(cuda, shape, axis, tile, forward):
    re, im = _grid_planes(shape, cuda, seed=sum(shape) + forward)
    n = shape[axis]
    plan = tt.create_plan(n)
    roots = ",roots" if n == 256 else ""  # the one radix-256 stage, bf16ax2
    call = tt.fftn_split if forward else tt.ifftn_split
    got, nd, rows, cols = _pass_counted(
        lambda: call(re, im, axes=(axis,), plans={n: plan}))
    assert nd == {"fft2_branch": 0, "axis_passes": 1, "relayout_bytes": 0}
    assert rows == {} and cols == {f"pipelined,tile{tile},cols{roots},mma": 1}
    want, nd, rows, cols = _pass_counted(
        lambda: _relayout_pass(re, im, axis, plan, forward))
    assert rows == {f"pipelined,tile{tile}{roots},mma": 1} and cols == {}
    _same_bits_and_strides(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["inner_undivided", "float32_input",
                                  "non_contiguous", "offset", "n4096_tile4"])
def test_columns_fall_back_to_the_relayout(cuda, case):
    n = 4096 if case == "n4096_tile4" else 512
    inner = 4100 if case == "inner_undivided" else 4096
    dtype = torch.float32 if case == "float32_input" else torch.bfloat16
    if case == "non_contiguous":
        re, im = (p[:, ::2] for p in _grid_planes((n, 2 * inner), cuda, seed=3))
    elif case == "offset":
        flat = _grid_planes((n * inner + 1,), cuda, seed=4)
        re, im = (p[1:].view(n, inner) for p in flat)
        assert re.data_ptr() % 16 and im.data_ptr() % 16
    else:
        re, im = _grid_planes((n, inner), cuda, seed=5, dtype=dtype)
    plan = tt.create_plan(n)
    got, nd, rows, cols = _pass_counted(
        lambda: tt.fftn_split(re, im, axes=(0,), plans={n: plan}))
    assert nd == {"fft2_branch": 0, "axis_passes": 1,
                  "relayout_bytes": 2 * 2 * n * inner}
    assert cols == {} and sum(rows.values()) == 1
    want, _, _, _ = _pass_counted(lambda: _relayout_pass(re, im, 0, plan, True))
    _same_bits_and_strides(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_grid_call_lands_axis_0_from_the_grid(cuda, forward):
    # The benchmark's call: fftn_split over the last three axes of a
    # (1, 512, 512, 512) view: K4 on the trailing two, then axis 1 lands
    # from K4's output with no copy, the parent's bits and strides.
    shape = (1, 512, 512, 512)
    re, im = _grid_planes(shape, cuda, seed=17 + forward)
    call = tt.fftn_split if forward else tt.ifftn_split
    got, nd, rows, cols = _pass_counted(lambda: call(re, im, axes=(-3, -2, -1)))
    assert nd == {"fft2_branch": 1, "axis_passes": 1, "relayout_bytes": 0}
    assert rows == {} and cols == {"pipelined,tile16,cols,mma": 1}
    mid = call(re, im, axes=(-2, -1))
    plan = fft_module._nd_plan(512, {"tuning": "auto"})
    _same_bits_and_strides(got, _relayout_pass(*mid, 1, plan, forward))
