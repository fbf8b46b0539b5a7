"""Kernel A's pipelined persistent kernel (``csrc/fused_fft_pipe.cu``).

On the CPU: the rule that picks it (``fused_cuda.takes_pipeline``), its
counter name, and what ``_launch_fused`` hands the C launcher, with the
launch recorded and the card's SM count passed in.

On the card (``-m gpu``; every such test skips without a CUDA device, decided
in the ``cuda`` fixture): its outputs equal ``fused_fft_tc_kernel``'s bit for
bit, the reference running the same rows in chunks of at most SMs rows, each
of which takes one CTA a row; a view off a 16-byte boundary takes one CTA a
row; the counter names the pipelined launch exactly when the rule holds.

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


@pytest.mark.parametrize("n,want", [(16384, True), (512, True), (1000, True),
                                    (1004, False), (256, False), (8, False)])
def test_selection_rule_needs_whole_16_byte_rows_of_512(n, want):
    # A row's planes are cp.async.bulk copies: whole 16-byte runs; below 512
    # elements one-CTA-a-row kernels share an SM and keep the old kernel.
    assert fused_cuda.takes_pipeline(
        dtype=torch.bfloat16, algorithm="bf16ax2", engine="stacked",
        stages=_stages({}), state_dtype="float32", cluster=1, batch=SMS + 1,
        n=n, pointers=[0, 16, 32, 48], sms=SMS) == want


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
    # batch, n, cluster, then the SMs the pipelined kernel walks (0: off).
    assert args[:4] == (batch, 1024, 1, SMS if on else 0)
    launched = collections.Counter(fused_cuda.fused_fft.variant_launches) - before
    assert launched == {"pipelined,mma" if on else "mma": 1}


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
    # b = SMs + 1, 4096, 4099: 4099 leaves the CTAs unequal row counts.  At
    # n = 256 the rule keeps one CTA a row; the pipelined kernel is forced.
    sms = fused_cuda.multiprocessors(cuda)
    b = sms + 1 if extra == 1 else extra
    re, im = _planes(b, n, cuda, seed=n + b + forward)
    kw = _kwargs(n, forward)
    on = n >= fused_cuda.CTA_THREADS
    got, launched = _launched(lambda: fused_cuda.fused_fft(re, im, **kw))
    assert launched == {"pipelined,mma" if on else "mma": 1}
    if not on:
        full = dict(kw, algorithm="bf16", first_dot="default", engine="stacked",
                    grouped=False, complex_mult="block", state_dtype="float32")
        got, launched = _launched(
            lambda: fused_cuda._launch_fused(re, im, pipelined=True, **full))
        assert launched == {"pipelined,mma": 1}
    chunks = [range(s, min(s + sms, b)) for s in range(0, b, sms)]
    want, launched = _launched(lambda: [
        torch.cat(parts) for parts in zip(*(
            fused_cuda.fused_fft(re[c.start:c.stop], im[c.start:c.stop], **kw)
            for c in chunks))])
    assert launched == {"mma": len(chunks)}
    _bitwise(got, want)


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
    assert launched == {"pipelined,mma": 1}
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
