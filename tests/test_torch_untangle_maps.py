"""The data movement of the R2C untangle pair on the card
(``csrc/rfft_epilogue.cu``: ``untangle_pairs_kernel`` K9,
``retangle_pairs_kernel`` K10), modelled in numpy.

The kernels cannot run here, so this file rebuilds their decomposition: the
grid (``pair_grid``: P threads per row segment, 256/P rows per pass, rows
split into groups of one wave), each thread's mirrored runs (the low run
[Vt, Vt+V) for t < ceil(q/2), the high run [M-V(t+1), M-Vt) for t <
floor(q/2), q = M/V), the one-element shift of the mirror through the
neighbour lane (or a load at a warp edge), bin 0 with the Nyquist bin, the
self-paired bin M/2, the realigned stores of K9 and the shifted chunk loads
of K10 on the pitch-(M+1) rows at every misalignment (row b mod V and the
phase of K10's input pointer), and the element-wise branch for M not a
multiple of V, where M < V is a partial run.  Each model tracks which input elements every
output is computed from and where it is stored, asserts that every output
element is written exactly once and from the right pair, then evaluates the
kernels' fp32 arithmetic on those elements and holds the result bit for bit
against ``untangle_fwd_reference`` / ``retangle_inv_reference``.
"""
import numpy as np
import pytest
import torch

from tensorfft_tpu_torch.ops import rfft_cuda

torch.set_num_threads(1)

THREADS = 256  # kPairThreads
WARP = 32
HALF_LENGTHS = [1, 2, 3, 4, 8, 12, 64, 1024]
BATCHES = range(1, 10)  # every b mod 8
# Resident CTAs of a pair kernel on the H100: 132 SMs, two CTAs each (the
# bf16 kernels take 100-odd registers a thread).
WAVE = 264
# (CTAs the grid aims at, the phase of K10's input pointer in elements): a
# card's wave and one CTA, rows starting on and off a 16-byte boundary.
LAUNCHES = [(WAVE, 0), (1, 3)]
STORAGE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def run_width(*dtypes):
    """V: elements of one 16-byte access, 8 when any side is bf16."""
    return 8 if torch.bfloat16 in dtypes else 4


def pair_grid(per_row, batch, target):
    """csrc pair_grid: (grid x, grid y, log2 P, rows per CTA)."""
    log2p = 0
    while (1 << log2p) < per_row and (1 << log2p) < THREADS:
        log2p += 1
    p = 1 << log2p
    per_pass = THREADS // p
    gx = -(-per_row // p)
    passes = -(-batch // per_pass)
    groups = min(max(target // gx, 1), passes)
    rows = -(-passes // groups) * per_pass
    return gx, -(-batch // rows), log2p, rows


def threads_per_row(m, v):
    """Run pairs per row: ceil(q/2) on the vector branch, else the pairs
    (k, M-k) for k <= M/2 in runs of V."""
    return (m // v + 1) // 2 if m % v == 0 else (m // 2) // v + 1


def lanes(bx, log2p):
    """pair_lane for every thread of CTA (bx, .): t, row in pass, first and
    last lane of the warp's share of the segment."""
    tid = np.arange(THREADS)
    p = 1 << log2p
    span = min(p, WARP)
    wl = tid & (span - 1)
    return bx * p + (tid & (p - 1)), tid >> log2p, wl == 0, wl == span - 1


def shfl(x, delta):
    """__shfl_down_sync (delta 1) / __shfl_up_sync (delta -1) of a per-thread
    array along axis 0: a source lane outside the warp returns the lane's
    own value."""
    tid = np.arange(THREADS)
    src = tid + delta
    ok = (src // WARP == tid // WARP) & (src >= 0) & (src < THREADS)
    out = x.copy()
    out[ok] = x[src[ok]]
    return out


def passes(m, batch, target, v):
    """Yield (CTA lanes, rows of one pass) over the whole grid."""
    gx, gy, log2p, rows_per_cta = pair_grid(threads_per_row(m, v), batch, target)
    assert gy <= 65535
    for by in range(gy):
        r0, r1 = by * rows_per_cta, min(batch, (by + 1) * rows_per_cta)
        for bx in range(gx):
            t, row, first, last = lanes(bx, log2p)
            for b0 in range(r0, r1, THREADS >> log2p):
                b = b0 + row
                yield t, first, last, b, b < r1


class Writes:
    """Every store of one output plane pair: (b, k) -> the (row, element,
    mirror element, phase index) it was computed from."""

    def __init__(self, batch, width):
        self.src = np.full((batch, width, 3), -1, np.int64)
        self.count = np.zeros((batch, width), np.int64)

    def put(self, b, k, rec):
        self.count[b, k] += 1
        self.src[b, k] = rec

    def check(self, expect):
        """Each element written once, from the pair ``expect(k)`` names."""
        assert (self.count == 1).all(), np.argwhere(self.count != 1)[:8]
        width = self.src.shape[1]
        want = np.array([expect(k) for k in range(width)])
        assert (self.src == want[None]).all(), np.argwhere(self.src != want[None])[:8]


def untangle_model(m, batch, v, target):
    """Writes of K9: X[b, k] from (Z[b, u], Z[b, mirror], w[k]); the Nyquist
    bin records (0, 0, -1).  X (allocated by the wrapper) starts on a
    16-byte boundary."""
    out = Writes(batch, m + 1)
    if m % v:
        half = m // 2
        for t, _, _, b, ok in passes(m, batch, target, v):
            for i in np.flatnonzero(ok):
                for k in range(v * t[i], v * t[i] + v):
                    if k > half:
                        continue
                    km = 0 if k == 0 else m - k
                    out.put(b[i], k, (k, km, k))
                    if k == 0:
                        out.put(b[i], m, (0, 0, -1))
                    elif km != k:
                        out.put(b[i], km, (km, k, km))
        return out
    q = m // v
    n_lo, n_hi = (q + 1) // 2, q // 2
    j = np.arange(v)
    for t, first, last, b, ok in passes(m, batch, target, v):
        lo, hi = ok & (t < n_lo), ok & (t < n_hi)
        k_lo, k_hi = v * t, m - v * (t + 1)
        low, high = k_lo[:, None] + j, k_hi[:, None] + j  # element indices
        # The one-element shift: Z[(M - Vt) mod M] from the run above,
        # Z[Vt + V] from the next low run.
        up, down = shfl(high[:, 0], -1), shfl(low[:, 0], 1)
        prev = np.where(t == 0, low[:, 0], np.where(first, m - k_lo, up))
        nxt = np.where(t + 1 >= n_lo, high[:, 0], np.where(last, k_lo + v, down))
        mirror_lo = np.where(j == 0, prev[:, None], high[:, (v - j) % v])
        mirror_hi = np.where(j == 0, nxt[:, None], low[:, (v - j) % v])
        rec_lo = np.stack([low, mirror_lo, low], -1)    # bins k_lo + j
        rec_hi = np.stack([high, mirror_hi, high], -1)  # bins k_hi + j
        st = (v - b % v) % v
        for i in np.flatnonzero(lo):
            _store_shifted(out, b[i], k_lo[i], rec_lo[i], shfl(rec_lo, 1)[i], st[i],
                           t[i] + 1 < n_lo and not last[i], first[i])
            if t[i] == 0:
                out.put(b[i], m, (0, 0, -1))
        for i in np.flatnonzero(hi):
            _store_shifted(out, b[i], k_hi[i], rec_hi[i], shfl(rec_hi, -1)[i], st[i],
                           t[i] >= 1 and not first[i],
                           not (t[i] + 1 < n_hi and not last[i]))
    return out


def _store_shifted(out, b, k0, own, nb, st, with_nb, head):
    """store_shifted: the aligned chunk [st, st + V) from the run and its
    neighbour, else the run's tail alone; its head alone when no lane
    before stores it."""
    v = len(own)
    m1 = out.src.shape[1]
    if st == 0:
        chunk = [(k0 + i, own[i]) for i in range(v)]
    else:
        chunk = []
        if with_nb:
            both = np.concatenate([own, nb])
            start = b * m1 + k0 + st
            assert start % v == 0  # a 16-byte store
            chunk += [(k0 + st + i, both[st + i]) for i in range(v)]
        else:
            chunk += [(k0 + i, own[i]) for i in range(st, v)]
        if head:
            chunk += [(k0 + i, own[i]) for i in range(st)]
    for k, rec in chunk:
        out.put(b, k, rec)


def retangle_model(m, batch, v, target, x_off):
    """Writes of K10: Z[b, k] from (X[b, k], X[b, M-k], w[k]), and every
    chunk K10 loads whole."""
    out = Writes(batch, m)
    whole = []
    if m % v:
        half = m // 2
        for t, _, _, b, ok in passes(m, batch, target, v):
            for i in np.flatnonzero(ok):
                for k in range(v * t[i], v * t[i] + v):
                    if k > half:
                        continue
                    out.put(b[i], k, (k, m - k, k))
                    if 0 < k != m - k:
                        out.put(b[i], m - k, (m - k, k, m - k))
        return out, whole
    q = m // v
    n_lo, n_hi = (q + 1) // 2, q // 2
    total = batch * (m + 1)
    j = np.arange(v)

    def chunk(a):
        """load_chunk of the flat X indices [a, a + V), -1 outside [0,
        total); relative to X's first element, the pointer x_off into its
        16-byte block."""
        idx = a + np.arange(v)
        if a >= 0 and a + v <= total:
            assert (x_off + a) % v == 0
            whole.append(a)
        return np.where((idx >= 0) & (idx < total), idx, -1)

    for t, first, last, b, ok in passes(m, batch, target, v):
        lo, hi = ok & (t < n_lo), ok & (t < n_hi)
        k_lo, k_hi = v * t, m - v * (t + 1)
        s = (x_off + b) % v
        a_lo, a_hi = b * (m + 1) + k_lo - s, b * (m + 1) + k_hi - s
        c_lo = np.full((THREADS, v), -1)
        c_hi = np.full((THREADS, v), -1)
        for i in np.flatnonzero(lo):
            c_lo[i], c_hi[i] = chunk(a_lo[i]), chunk(a_hi[i])
        n_lo_c, u_hi_c = shfl(c_lo, 1), shfl(c_hi, -1)
        for i in np.flatnonzero(lo):
            if not (t[i] + 1 < n_lo and not last[i]):
                n_lo_c[i] = chunk(a_lo[i] + v)
            if not (t[i] >= 1 and not first[i]):
                u_hi_c[i] = chunk(a_hi[i] + v)
        for i in np.flatnonzero(lo):
            low = np.concatenate([c_lo[i], n_lo_c[i]])[s[i]:s[i] + v + 1]
            high = np.concatenate([c_hi[i], u_hi_c[i]])[s[i]:s[i] + v + 1]
            row = b[i] * (m + 1)
            for jj in j:
                out.put(b[i], k_lo[i] + jj, (low[jj] - row, high[v - jj] - row, k_lo[i] + jj))
                if hi[i]:
                    out.put(b[i], k_hi[i] + jj, (high[jj] - row, low[v - jj] - row, k_hi[i] + jj))
    return out, whole


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(2)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))


def _untangle_values(z_re, z_im, src, m, scale):
    """The kernels' K9 arithmetic (untangle_bin; the Nyquist bin) on the
    elements the model names, in fp32, rounded once to Z's dtype."""
    f32 = np.float32
    zr, zi = z_re.float().numpy(), z_im.float().numpy()
    rows = np.arange(zr.shape[0])[:, None]
    u, zm, k = src[..., 0], src[..., 1], src[..., 2]
    cos, sin = rfft_cuda.phase_tables(2 * m, -1, m)
    w_re, w_im = cos[np.maximum(k, 0)], sin[np.maximum(k, 0)]
    u_re, u_im = zr[rows, u], zi[rows, u]
    v_re, v_im = zr[rows, zm], -zi[rows, zm]
    a_re, a_im = u_re + v_re, u_im + v_im
    b_re, b_im = u_re - v_re, u_im - v_im
    c_re = w_re * b_im + w_im * b_re
    c_im = -(w_re * b_re - w_im * b_im)
    o_re = (a_re + c_re) * f32(scale)
    o_im = (a_im + c_im) * f32(scale)
    nyq = k < 0
    o_re = np.where(nyq, f32(2.0 * scale) * (zr[rows, u] - zi[rows, u]), o_re)
    o_im = np.where(nyq, f32(0.0), o_im)
    return [torch.from_numpy(o.astype(np.float32)).to(z_re.dtype) for o in (o_re, o_im)]


def _retangle_values(x_re, x_im, src, m, scale, out_dtype):
    """The kernels' K10 arithmetic (retangle_bin) on the model's elements."""
    f32 = np.float32
    xr, xi = x_re.float().numpy(), x_im.float().numpy()
    rows = np.arange(xr.shape[0])[:, None]
    xk, xm, k = src[..., 0], src[..., 1], src[..., 2]
    cos, sin = rfft_cuda.phase_tables(2 * m, 1, m)
    w_re, w_im = cos[k], sin[k]
    k_re, k_im = xr[rows, xk], xi[rows, xk]
    r_re, r_im = xr[rows, xm], -xi[rows, xm]
    a_re, a_im = k_re + r_re, k_im + r_im
    b_re, b_im = k_re - r_re, k_im - r_im
    c_re = -(w_re * b_im + w_im * b_re)
    c_im = w_re * b_re - w_im * b_im
    return [torch.from_numpy(((a + c) * f32(scale)).astype(np.float32)).to(out_dtype)
            for a, c in ((a_re, c_re), (a_im, c_im))]


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", HALF_LENGTHS)
def test_untangle_model_matches_plain(m, precision):
    dtype = STORAGE[precision]
    v = run_width(dtype)
    for target, _ in LAUNCHES:
        for batch in BATCHES:
            writes = untangle_model(m, batch, v, target)
            writes.check(lambda k: (0, 0, -1) if k == m
                         else (k, (m - k) % m, k))
            z = _planes((batch, m), dtype, seed=m * 10 + batch)
            scale = 1.0 / (2 * m)
            _assert_bitwise(_untangle_values(*z, writes.src, m, scale),
                            rfft_cuda.untangle_fwd_reference(*z, n=2 * m, scale=scale))


@pytest.mark.parametrize("precision,out", [("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32"),
                                           ("float32", "bfloat16"),
                                           ("float32", "float32")])
@pytest.mark.parametrize("m", HALF_LENGTHS)
def test_retangle_model_matches_plain(m, precision, out):
    dtype, out_dtype = STORAGE[precision], STORAGE[out]
    v = run_width(dtype, out_dtype)
    for target, x_off in LAUNCHES:
        for batch in BATCHES:
            writes, whole = retangle_model(m, batch, v, target, x_off)
            writes.check(lambda k: (k, m - k, k))
            # Whole chunks lie inside X.  On rows of at least four runs each
            # is loaded once but at the edges of a warp's span and where two
            # rows share one.
            whole = np.array(whole, np.int64)
            assert ((whole >= 0) & (whole + v <= batch * (m + 1))).all()
            if m >= 8 * v:
                _, repeats = np.unique(whole, return_counts=True)
                assert repeats.max() <= 2
                assert len(whole) <= 1.25 * len(repeats)
            x = _planes((batch, m + 1), dtype, seed=m * 10 + batch + 1)
            scale = 2.0
            _assert_bitwise(_retangle_values(*x, writes.src, m, scale, out_dtype),
                            rfft_cuda.retangle_inv_reference(*x, n=2 * m, scale=scale,
                                                             out_dtype=out_dtype))


@pytest.mark.parametrize("m,batch", [(16384, 4096), (1 << 19, 16), (2048, 4096),
                                     (256, 262144), (256, 70000)])
def test_pair_grid_fills_the_card(m, batch):
    """At the main paths' shapes (the fused and config-4 R2C routes,
    ``rfftn_split``'s last axis at 4096 x 4096 and 512^3, a batch past the
    65535 grid-y limit) the grid is at most one wave of resident CTAs, fills
    the 132 SMs, and covers every row once."""
    for v in (8, 4):
        per_row = threads_per_row(m, v)
        gx, gy, log2p, rows = pair_grid(per_row, batch, WAVE)
        assert 132 <= gx * gy <= WAVE
        assert gy <= 65535 and gx * (1 << log2p) >= per_row
        assert (gy - 1) * rows < batch <= gy * rows
        assert rows % (THREADS >> log2p) == 0


def test_vector_runs_read_each_input_once():
    """K9's vector loads: the low and high runs of a row's threads tile [0,
    M) exactly (the middle thread of an odd q loads one run twice)."""
    for m, v in [(64, 8), (72, 8), (1024, 8), (12, 4), (1024, 4)]:
        q = m // v
        n_lo = (q + 1) // 2
        seen = np.zeros(m, np.int64)
        for t in range(n_lo):
            k_lo, k_hi = v * t, m - v * (t + 1)
            seen[k_lo:k_lo + v] += 1
            if k_hi != k_lo:
                seen[k_hi:k_hi + v] += 1
        assert (seen == 1).all(), (m, v)
