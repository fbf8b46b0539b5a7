"""FFT planning layer (PyTorch / CUDA port of ``tensorfft_tpu.plan``).

A plan is a pure function of ``(fft_length, precision policy, tuning)``: the
radix factorization, the execution strategy (one fused CUDA kernel, the Bailey
four-step pair of CUDA kernels, the plain-torch staged loop, or ``torch.fft``)
and the knobs the kernels read.  The planner is numpy-only and produces the
same ``FFTPlan`` field for field as the JAX package, so the two packages run
the same math from the same plan.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple

__all__ = [
    "Precision",
    "Strategy",
    "FFTPlan",
    "create_plan",
    "plan_works_on_device",
    "is_power_of_2",
    "exact_log2",
    "balanced_radices",
    "optimal_radices",
    "default_four_step_split",
    "ENGINES",
    "STATE_DTYPES",
    "COMPLEX_MULTS",
    "PLANAR_ENGINES",
    "MAX_KLOOP",
    "stage_kinds",
    "grouped_mult3",
    "gridslice_layout",
    "gridslice_fits",
    "effective_state_dtype",
]

# The values of the engine and numeric knobs.  Every one runs on the CPU
# (plain torch) and on the card (the CUDA kernels).
ENGINES = ("stacked", "planar", "planar_vpu", "pretwiddle", "gridslice",
           "gridslice8", "gridslice16")
STATE_DTYPES = ("float32", "bfloat16")
COMPLEX_MULTS = ("block", "mult3")

# Largest transform the default plan runs as one fused whole-transform pass;
# longer transforms take the four-step route.  Kept equal to the JAX
# package's default so both packages pick the same route for every length.
DEFAULT_MAX_FUSED_LENGTH = 16384


class Precision(str, enum.Enum):
    """Numeric policy: storage dtype plus matmul operand decomposition.

    Every policy accumulates stage matmuls in fp32; the policy picks the
    dtype data is stored in between passes and how many bf16 split terms
    represent each matmul operand (``ops/dots.py``).
    """

    BFLOAT16 = "bfloat16"      # bf16 storage, 1 bf16 product
    FLOAT32 = "float32"        # f32 storage, bf16x3 compensated products
    FLOAT32_X6 = "float32_x6"  # f32 storage, bf16x6 (near-exact f32)
    FLOAT64 = "float64"        # exact; reference/oracle path only (CPU)

    @property
    def storage_dtype(self):
        import torch

        return {
            Precision.BFLOAT16: torch.bfloat16,
            Precision.FLOAT32: torch.float32,
            Precision.FLOAT32_X6: torch.float32,
            Precision.FLOAT64: torch.float64,
        }[self]

    @property
    def compute_dtype(self):
        import torch

        return torch.float64 if self is Precision.FLOAT64 else torch.float32

    @property
    def dot_algorithm(self) -> str:
        """Operand decomposition for stage matmuls (see ops/dots.py)."""
        return {
            Precision.BFLOAT16: "bf16",
            Precision.FLOAT32: "bf16x3",
            Precision.FLOAT32_X6: "bf16x6",
            Precision.FLOAT64: "exact",
        }[self]


class Strategy(str, enum.Enum):
    """Execution strategy."""

    AUTO = "auto"
    FUSED = "fused"            # one CUDA kernel, whole transform per CTA
    FOUR_STEP = "four_step"    # Bailey decomposition: column + row kernels
    STAGED = "staged"          # plain-torch stage loop
    TORCH = "torch"            # torch.fft.fft comparison path


def is_power_of_2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def exact_log2(x: int) -> int:
    if not is_power_of_2(x):
        raise ValueError(f"{x} is not a power of 2")
    return x.bit_length() - 1


def balanced_radices(n: int) -> Tuple[int, ...]:
    """Factor n = 2^p into ceil(p/7) nearly-equal power-of-two radices <= 128,
    ascending."""
    p = exact_log2(n)
    if p == 0:
        return ()
    max_log = 7
    stages = max(1, math.ceil(p / max_log))
    base, rem = divmod(p, stages)
    logs = [base + 1] * rem + [base] * (stages - rem)
    logs.sort()
    return tuple(1 << l for l in logs)


# Padded-MAC cost per input element of one block-complex radix-R stage on a
# 128-wide matrix unit: c(R) = max(2R, 128)^2 / R, minimized at R = 64.  The
# cost model is the JAX package's, kept so the port plans the same radices.
_STAGE_COST = {
    (1 << a): max(2 << a, 128) ** 2 // (1 << a) for a in range(1, 9)
}


def optimal_radices(n: int) -> Tuple[int, ...]:
    """Factor n = 2^p minimizing the summed per-stage cost _STAGE_COST
    (dynamic program over partitions of p), ascending."""
    p = exact_log2(n)
    if p == 0:
        return ()
    best: dict[int, Tuple[int, Tuple[int, ...]]] = {0: (0, ())}
    for q in range(1, p + 1):
        candidates = []
        for a in range(1, min(8, q) + 1):
            cost_tail, rad_tail = best[q - a]
            candidates.append((cost_tail + _STAGE_COST[1 << a], rad_tail + (1 << a,)))
        best[q] = min(candidates)
    return tuple(sorted(best[p][1]))


def default_four_step_split(n: int, max_fused: int) -> Tuple[int, int]:
    """Split n = n1 * n2 with both factors <= max_fused.

    n1 is the column (first-pass) length, n2 the row (second-pass) length:
    balanced up to 2^15, then n2 capped at 4096 unless that would push n1
    past ``max_fused``.
    """
    p = exact_log2(n)
    pf = exact_log2(max_fused)
    if p > 2 * pf:
        raise ValueError(
            f"fft_length {n} too large for a two-pass four-step with "
            f"max_fused_length {max_fused}"
        )
    if p <= 15:
        p1 = p // 2
    else:
        p2 = max(p - pf, min(pf, 12, p - 7))
        p1 = p - p2
    p2 = p - p1
    if p2 > pf or p1 > pf:
        raise ValueError(
            f"no two-pass split of {n} fits max_fused_length {max_fused}"
        )
    return (1 << p1, 1 << p2)


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Immutable description of how to execute one FFT configuration.

    Field for field the JAX package's ``FFTPlan``.  The knobs that only shape
    the TPU kernels' layout (``lane_tile``, ``kloop_width``, ``k1_tile``,
    ``interleave_downcast``) are kept so plans compare equal; the CUDA
    kernels do not read them.  ``lane_tile`` still fixes how the four-step
    twiddle is factored into P/Q tables, which the port reproduces;
    ``lane_tile`` and ``k1_tile`` decide the four-step passes' narrow-panel
    fallback to fp32 state (:func:`effective_state_dtype`), as in the JAX
    package; and ``fused_layout="batch_major"`` selects the batch-major
    fused kernel (K3) where the JAX dispatch does.
    """

    fft_length: int
    radices: Tuple[int, ...]
    precision: Precision = Precision.BFLOAT16
    strategy: Strategy = Strategy.AUTO
    four_step_split: Optional[Tuple[int, int]] = None
    col_radices: Optional[Tuple[int, ...]] = None
    row_radices: Optional[Tuple[int, ...]] = None
    lane_tile: int = 128
    scaling: str = "forward"
    max_fused_length: int = DEFAULT_MAX_FUSED_LENGTH
    grouped: bool = False
    fused_layout: str = "auto"
    kloop_width: int = 128
    state_dtype: str = "float32"
    complex_mult: str = "block"
    engine: str = "stacked"
    first_dot: str = "default"
    k1_tile: int = 128
    interleave_downcast: bool = False

    def __post_init__(self):
        if not is_power_of_2(self.fft_length):
            raise ValueError(
                f"fft_length must be a power of 2, got {self.fft_length}"
            )
        if math.prod(self.radices) != self.fft_length:
            raise ValueError(
                f"radices {self.radices} do not multiply to {self.fft_length}"
            )
        for r in self.radices:
            if not is_power_of_2(r):
                raise ValueError(f"radix {r} is not a power of 2")
        if self.scaling not in ("forward", "none", "ortho"):
            raise ValueError(f"bad scaling {self.scaling!r}")
        if self.fused_layout not in ("auto", "batch_major", "transform_major"):
            raise ValueError(f"bad fused_layout {self.fused_layout!r}")
        if self.state_dtype not in STATE_DTYPES:
            raise ValueError(f"bad state_dtype {self.state_dtype!r}")
        if self.complex_mult not in COMPLEX_MULTS:
            raise ValueError(f"bad complex_mult {self.complex_mult!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"bad engine {self.engine!r}")
        if self.first_dot not in ("default", "bf16ax2"):
            raise ValueError(f"bad first_dot {self.first_dot!r}")
        if not isinstance(self.interleave_downcast, bool):
            raise ValueError(
                f"interleave_downcast must be a bool, "
                f"got {self.interleave_downcast!r}"
            )
        if self.k1_tile < 128 or not is_power_of_2(self.k1_tile):
            raise ValueError(
                f"k1_tile must be a power of 2 >= 128, got {self.k1_tile}"
            )
        if self.four_step_split is not None:
            n1, n2 = self.four_step_split
            if n1 * n2 != self.fft_length:
                raise ValueError("four_step_split does not factor fft_length")
            if self.col_radices is not None and math.prod(self.col_radices) != n1:
                raise ValueError(
                    f"col_radices {self.col_radices} do not multiply to n1={n1}"
                )
            if self.row_radices is not None and math.prod(self.row_radices) != n2:
                raise ValueError(
                    f"row_radices {self.row_radices} do not multiply to n2={n2}"
                )
        if self.resolve_strategy() is Strategy.FOUR_STEP:
            if self.four_step_split is None:
                raise ValueError(
                    "strategy 'four_step' requires four_step_split=(n1, n2)"
                )
            if self.col_radices is None or self.row_radices is None:
                raise ValueError(
                    "strategy 'four_step' requires col_radices and row_radices"
                )

    @property
    def log2_length(self) -> int:
        return exact_log2(self.fft_length)

    @property
    def amount_of_stages(self) -> int:
        return len(self.radices)

    @property
    def stage_scale(self) -> Tuple[float, ...]:
        """Per-stage progressive scale factors (product = total scale)."""
        if self.scaling == "forward":
            return tuple(1.0 / r for r in self.radices)
        if self.scaling == "ortho":
            return tuple(r ** -0.5 for r in self.radices)
        return tuple(1.0 for _ in self.radices)

    def resolve_strategy(self) -> Strategy:
        if self.strategy is not Strategy.AUTO:
            return self.strategy
        if self.fft_length <= self.max_fused_length:
            return Strategy.FUSED
        return Strategy.FOUR_STEP


def create_plan(
    fft_length: int,
    precision: str | Precision = Precision.BFLOAT16,
    strategy: str | Strategy = Strategy.AUTO,
    radices: Optional[Sequence[int]] = None,
    lane_tile: Optional[int] = None,
    scaling: str = "forward",
    max_fused_length: int = DEFAULT_MAX_FUSED_LENGTH,
    tuning: Optional[dict] = None,
    fused_layout: Optional[str] = None,
    batch_hint: Optional[int] = None,
) -> FFTPlan:
    """Create an :class:`FFTPlan` for a power-of-two ``fft_length`` >= 2.

    ``tuning`` is a dict whose keys override the computed defaults, or
    ``"auto"`` to look ``(fft_length, precision, platform)`` up in the tuner
    cache (:class:`tensorfft_tpu_torch.tuning.TunerCache`; untuned if it has
    no entry).  The platform is ``"cuda"`` when a CUDA device is available
    and ``"cpu"`` otherwise; ``batch_hint`` selects an entry tuned at that
    batch where one exists.
    """
    if not is_power_of_2(fft_length) or fft_length < 2:
        raise ValueError(
            f"fft_length must be a power of 2 (>= 2), got {fft_length}"
        )
    precision = Precision(precision)
    strategy = Strategy(strategy)

    if tuning == "auto":
        import torch

        from tensorfft_tpu_torch.tuning import TunerCache

        platform = "cuda" if torch.cuda.is_available() else "cpu"
        tuning = TunerCache().get(fft_length, precision.value, platform,
                                  batch=batch_hint)

    tuning = dict(tuning or {})
    grouped = False
    if "radices" in tuning and radices is None:
        radices = tuple(tuning["radices"])
    if "lane_tile" in tuning and lane_tile is None:
        lane_tile = int(tuning["lane_tile"])
    if "grouped" in tuning:
        grouped = bool(tuning["grouped"])
    if "strategy" in tuning and strategy is Strategy.AUTO:
        strategy = Strategy(tuning["strategy"])
    if "max_fused_length" in tuning:
        max_fused_length = int(tuning["max_fused_length"])
    if "fused_layout" in tuning and fused_layout is None:
        fused_layout = str(tuning["fused_layout"])
    state_dtype = str(tuning.get("state_dtype", "float32"))
    kloop_width = int(tuning.get("kloop_width", 128))
    complex_mult = str(tuning.get("complex_mult", "block"))
    engine = str(tuning.get("engine", "stacked"))
    first_dot = str(tuning.get("first_dot", "auto"))
    k1_tile = int(tuning.get("k1_tile", 128))
    interleave_downcast = bool(tuning.get("interleave_downcast", False))
    if first_dot == "auto":
        # Small bf16 transforms split the first stage's matrix into hi+lo
        # bf16 terms: the first stage dominates small-N deviation.
        first_dot = (
            "bf16ax2"
            if precision is Precision.BFLOAT16 and fft_length <= 1024
            else "default"
        )

    four_step_split = None
    col_radices = None
    row_radices = None
    resolved = strategy
    if resolved is Strategy.AUTO:
        resolved = (
            Strategy.FUSED
            if fft_length <= max_fused_length
            else Strategy.FOUR_STEP
        )
    if resolved is Strategy.FOUR_STEP:
        split = tuning.get("four_step_split")
        if split is None:
            split = default_four_step_split(fft_length, max_fused_length)
        four_step_split = (int(split[0]), int(split[1]))
        col_radices = optimal_radices(four_step_split[0])
        row_radices = optimal_radices(four_step_split[1])
        if tuning.get("col_radices"):
            col_radices = tuple(int(r) for r in tuning["col_radices"])
        if tuning.get("row_radices"):
            row_radices = tuple(int(r) for r in tuning["row_radices"])

    if radices is None:
        radices = optimal_radices(fft_length)
    if lane_tile is None:
        lane_tile = 128

    return FFTPlan(
        fft_length=int(fft_length),
        radices=tuple(int(r) for r in radices),
        precision=precision,
        strategy=strategy,
        four_step_split=four_step_split,
        col_radices=col_radices,
        row_radices=row_radices,
        lane_tile=int(lane_tile),
        scaling=scaling,
        max_fused_length=int(max_fused_length),
        grouped=grouped,
        fused_layout=fused_layout if fused_layout is not None else "auto",
        state_dtype=state_dtype,
        kloop_width=kloop_width,
        complex_mult=complex_mult,
        engine=engine,
        first_dot=first_dot,
        k1_tile=k1_tile,
        interleave_downcast=interleave_downcast,
    )


# The planar engines keep re and im apart; under them ``grouped`` and
# ``complex_mult`` change nothing, as in the JAX package, whose planar stage
# loop never reads them.  Every other engine (stacked, pretwiddle,
# gridslice*) runs the stacked stage engine.
PLANAR_ENGINES = ("planar", "planar_vpu")

# Stages whose accumulated sub-transform count K exceeds this are 'big'
# stages (fused_pallas._MAX_KLOOP); under the planar engine, stages with
# 1 < K <= this many fold the twiddle into per-slice matrices.
MAX_KLOOP = 128


def stage_kinds(radices, grouped: bool):
    """Per stage (kind, radix, k, p): the JAX package's
    ``fused_pallas._stage_kinds``, which the stacked engine's tables and
    rounding follow.

    kind is 'first' (k == 1), 'grouped' (the twiddle folded into per-slice
    matrices; p slices per TPU matmul), 'kloop' (k <= MAX_KLOOP) or 'big';
    k is the number of sub-transforms built before the stage.  A stage is
    grouped only under ``grouped`` when k // p <= MAX_KLOOP, p >= 2 or the
    radix is at least 64, and the TPU's block-diagonal table of
    4 * k * p * R^2 entries stays within 2^24.
    """
    k = 1
    for radix in radices:
        p = max(1, 128 // (2 * radix))
        p = min(p, k)
        if k == 1:
            yield ("first", radix, k, 1)
        elif (grouped and k % p == 0 and (k // p) <= MAX_KLOOP
              and (p >= 2 or radix >= 64)
              and 4 * k * p * radix * radix <= (1 << 24)):
            yield ("grouped", radix, k, p)
        elif k <= MAX_KLOOP:
            yield ("kloop", radix, k, 1)
        else:
            yield ("big", radix, k, 1)
        k *= radix


def grouped_mult3(kind: str, radix: int, p: int, complex_mult: str) -> bool:
    """Whether a grouped stage runs as three real products on the folded
    (K, 3R, R) tables (``fused_pallas._grouped_mult3``): p == 1 stages of
    radix >= 128 under ``complex_mult='mult3'``."""
    return (kind == "grouped" and complex_mult == "mult3"
            and p == 1 and radix >= 128)


def gridslice_layout(radices, grouped: bool) -> Optional[int]:
    """The last stage's slice count S, or None where a gridslice engine
    cannot take the plan (``fused_pallas.gridslice_layout``): the last stage
    must be a kloop or a p == 1 grouped stage, and S a multiple of 8."""
    kind, _, k, p = list(stage_kinds(radices, grouped))[-1]
    if (kind == "kloop" or (kind == "grouped" and p == 1)) and k % 8 == 0:
        return k
    return None


def gridslice_fits(engine: str, radices, grouped: bool) -> bool:
    """Whether the gridslice ``engine`` can take the plan: its last stage
    emits whole slices (:func:`gridslice_layout`) in blocks of the engine's
    slice block, 8 or its suffix (``fused_pallas.py:895-905``)."""
    s_total = gridslice_layout(radices, grouped)
    return s_total is not None and s_total % int(engine[len("gridslice"):] or 8) == 0


def effective_state_dtype(state_dtype: str, n1: int, n2: int, lane_tile: int,
                          k1_tile: int) -> str:
    """The state dtype a four-step pass pair (C2C, K5, K6) runs: the JAX
    package falls back to fp32 state when a TPU panel is narrower than 128
    lanes, min(lane_tile, n2) or min(k1_tile, n1)
    (``four_step_pallas.py:335-339``); read from the plan, so both packages
    round alike."""
    if min(min(lane_tile, n2), min(k1_tile, n1)) < 128:
        return "float32"
    return state_dtype


def plan_works_on_device(plan: FFTPlan, device="cuda") -> Tuple[bool, str]:
    """Check that ``plan`` can run on ``device``; returns (ok, reason).

    A CPU device runs the plain-torch versions, which take every plan the
    planner makes.  A CUDA device runs the hand-written kernels, which take
    every engine and knob, and the float64 policy has no kernel.  Each pass
    (the fused transform, or each four-step pass) must fit a thread-block
    cluster of at most ``max_cluster`` (8) CTAs on the H100
    (``utils.device.H100``): one CTA holds 16384 complex elements in 227 KB
    of shared memory (the split operand, with the third operand plane of a
    pass that runs mult3 stages), and a longer pass is split over 2, 4 or 8
    CTAs (``ops.fused_cuda.fit_cta``), so a pass of up to 131072 elements
    runs (65536 under bf16x6 with mult3 stages).  The refusal names the
    cluster limit.
    """
    import torch

    from tensorfft_tpu_torch.ops.fused_cuda import fit_cta, pass_stages
    from tensorfft_tpu_torch.utils.device import device_spec

    device = torch.device(device)
    if device.type == "cpu":
        return (True, "ok")
    spec = device_spec(device)
    resolved = plan.resolve_strategy()
    if resolved not in (Strategy.FUSED, Strategy.FOUR_STEP):
        return (True, "ok")
    if plan.precision is Precision.FLOAT64:
        return (False, "float64 plans are CPU/oracle-only")
    passes = ([(plan.fft_length, plan.radices)] if resolved is Strategy.FUSED
              else list(zip(plan.four_step_split,
                            (plan.col_radices, plan.row_radices))))
    algorithm = plan.precision.dot_algorithm
    for n, radices in passes:
        stages = pass_stages(tuple(radices), plan.engine, plan.grouped,
                             plan.complex_mult)
        try:
            fit_cta(n, 1, algorithm, stages, f"a length-{n} pass on {spec.kind}")
        except ValueError as err:
            return (False, str(err))
    return (True, "ok")
