"""A NumPy model of the output-stationary original-order decode of u64 and
u32 (`decode_orig_kernel` in fastlanes_tpu_torch/csrc/codecs.cu), held bit
for bit (tolerance 0) against the port's NumPy oracle and its plain versions.

The CUDA kernel does not run on the CPU. What can go wrong in it beyond the
plain version's arithmetic is its index arithmetic: which packed word each
thread's cp.async puts where in shared memory, which words a thread's rows
read there, which thread copies which base word, the warp scan of the
running sum (__shfl_up_sync within a lane's threads, the carry of each store
run and the base), and where each 16-byte store lands. The model follows
the kernel's code line by line on numpy arrays, one column per thread (256
threads, NB FastLanes blocks a CUDA block), checks that the grid covers
every block once and that every shared word it reads was copied in, and
counts the writes of every output value. It also counts the shared-memory
wavefronts of each warp-wide access, which the kernel's comment states."""

import numpy as np
import pytest
import torch

from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ref import numpy_ref as ref

THREADS = 256
OPS = ("unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig")
DTYPES = ("u32", "u64")
CONFIGS = [(dt, w) for dt in DTYPES for w in range(layout.bit_width(dt) + 1)]


class Shape:
    """OrigOut<T> of codecs.cu."""

    def __init__(self, dt):
        self.tbits = layout.bit_width(dt)
        self.lanes = 1024 // self.tbits
        self.nb = 16 // (self.tbits // 8)
        assert self.nb == ck.ORIG_DECODE_BLOCKS_PER_CTA[dt]
        self.rows = 1024 // THREADS
        self.tpl = self.tbits // self.rows
        self.vec = 16 // (self.tbits // 8)
        self.ns = self.rows // self.vec
        self.pitch = self.tbits + 1
        self.copies = 1024 // THREADS

    def row(self, s, j, i):
        return s * (self.tbits // self.ns) + self.vec * j + i

    def block_counts(self):
        """One block, NB - 1, NB + 1 and a ragged count above 2 * NB."""
        return sorted({1, self.nb - 1, self.nb + 1, 2 * self.nb + 1})


def fl_order(o):
    return ((o & 1) << 2) | (o & 2) | ((o >> 2) & 1)


def seg(lane, tbits):
    """Orig<T>::seg of codecs.cu."""
    return (lane & 15) * (64 // tbits) + fl_order(lane >> 4) // (tbits // 8)


def wavefronts(word_index, tbits):
    """Shared-memory wavefronts of one warp-wide access of T words at
    `word_index` (one entry per thread; broadcasts of one word are free): a
    word of 4 bytes takes one bank, of 8 bytes two. The most distinct words
    that meet in one bank group."""
    groups = 32 // (tbits // 32)
    distinct = np.unique(word_index)
    return int(np.bincount(distinct % groups, minlength=groups).max())


def shfl_up(x, d, width):
    """__shfl_up_sync(full, x, d, width): thread t takes t - d's value, or
    keeps its own where t - d lies before its segment of `width`."""
    t = np.arange(x.shape[1])
    return x[:, np.where(t % width >= d, t - d, t)]


def shfl(x, src, width):
    """__shfl_sync(full, x, src, width): thread t takes the value of thread
    `src` of its segment of `width`."""
    t = np.arange(x.shape[1])
    return x[:, (t // width) * width + src]


def model_decode(name, packed, base, width, dt, stats=None):
    """decode_orig_kernel<T, OP>: (B, LANES*W) packed -> (B, 1024) in
    original order. base: (LANES,) shared (stride 0) or (B, LANES) per block
    (stride LANES), read as the kernel reads it. `stats`, a dict, collects
    the worst wavefront count of the row loads and the copies' worst count
    beyond the least their bytes need."""
    sh = Shape(dt)
    t, np_dt = sh.tbits, layout.np_dtype(dt)
    n_blocks = packed.shape[0]
    # the grid: CUDA block c decodes its live blocks c*NB + fb, fb < live;
    # the model keeps the words and the threads of every block side by side
    grid = -(-n_blocks // sh.nb)
    decoded = [c * sh.nb + fb for c in range(grid)
               for fb in range(min(sh.nb, n_blocks - c * sh.nb))]
    assert decoded == list(range(n_blocks))
    tid = np.arange(THREADS)
    n_words = sh.lanes * width
    src = np.ascontiguousarray(packed).reshape(n_blocks, n_words)  # packed + b*n_words
    words = np.zeros((n_blocks, sh.lanes * sh.pitch), np_dt)
    copied = np.zeros(sh.lanes * sh.pitch, bool)
    worst = {"copy": 0, "rows": 0}
    for c in range(sh.copies):
        g = tid + c * THREADS
        live = g < n_words
        at = (g % sh.lanes) * sh.pitch + g // sh.lanes
        assert not copied[at[live]].any()  # no word copied twice
        words[:, at[live]] = src[:, g[live]]
        copied[at[live]] = True
        for warp in range(THREADS // 32 if stats is not None else 0):
            sel = live[32 * warp:32 * warp + 32]
            if sel.any():  # beyond the least that many bytes need
                least = -(-int(sel.sum()) * t // 8 // 128)
                worst["copy"] = max(worst["copy"], wavefronts(
                    at[32 * warp:32 * warp + 32][sel], t) - least)
    assert copied.sum() == n_words

    lane, j = tid // sh.tpl, tid % sh.tpl
    s = lane * sh.pitch  # words + lane * PITCH
    mask = np_dt.type((1 << width) - 1) if width < t else np_dt.type(~np_dt.type(0))
    one = np_dt.type(1)
    v = [[None] * sh.vec for _ in range(sh.ns)]
    for n in range(sh.ns):
        for i in range(sh.vec):
            r = sh.row(n, j, i)
            if width > 0:  # row_bits: funnel_right(s[k], s[k + 1], shift) & mask
                bit = r * width
                k, shift = bit // t, bit % t
                assert (k + 1 < sh.pitch).all()  # s[k + 1] stays in the lane's row
                straddle = shift + width > t
                # the bits used lie in copied words; s[k + 1] is read anyway
                assert copied[s + k].all() and copied[(s + k + 1)[straddle]].all()
                lo, hi = words[:, s + k], words[:, s + k + 1]
                x = (lo >> shift.astype(np_dt)) | (
                    (hi << np_dt.type(1)) << (t - 1 - shift).astype(np_dt))
                x = x & mask
                for warp in range(THREADS // 32 if stats is not None else 0):
                    w32 = slice(32 * warp, 32 * warp + 32)
                    worst["rows"] = max(worst["rows"], wavefronts((s + k)[w32], t),
                                        wavefronts((s + k + 1)[w32], t))
            else:
                x = np.zeros((n_blocks, THREADS), np_dt)
            if name == "unzdelta_pack_orig":  # Lanes<T>::unzigzag
                x = (x >> one) ^ (np.zeros_like(x) - (x & one))
            v[n][i] = x
    if name in ("undelta_pack_orig", "unzdelta_pack_orig"):
        # thread t < NB*LANES copies base word t % LANES of block t // LANES
        # of its CUDA block into bases[fb][lane]; a thread's carry is its
        # lane's word there
        base_stride = sh.lanes if base.ndim == 2 else 0
        flat = np.ascontiguousarray(base).reshape(-1)
        b, ln = np.arange(n_blocks)[:, None], np.arange(sh.lanes)
        copier = (b % sh.nb) * sh.lanes + ln  # the thread that copies (b, ln)
        assert copier.max() < THREADS and np.unique(copier).size == min(n_blocks, sh.nb) * sh.lanes
        bases = flat[b * base_stride + ln]
        carry = bases[:, lane]
        for n in range(sh.ns):
            part = np.zeros((n_blocks, THREADS), np_dt)
            for i in range(sh.vec):
                part = part + v[n][i]
            incl = part
            d = 1
            while d < sh.tpl:
                up = shfl_up(incl, d, sh.tpl)
                incl = np.where(j >= d, incl + up, incl)
                d *= 2
            run = carry + (incl - part)
            for i in range(sh.vec):
                run = run + v[n][i]
                v[n][i] = run
            carry = carry + shfl(incl, sh.tpl - 1, sh.tpl)
    out = np.zeros((n_blocks, layout.BLOCK), np_dt)
    writes = np.zeros(layout.BLOCK, np.int64)
    o = np.array([seg(int(x), t) for x in lane]) * t  # out + b*1024 + seg(lane)*T
    for n in range(sh.ns):
        at = o + sh.row(n, j, 0)
        assert (at * (t // 8) % 16 == 0).all()  # store16 is 16-byte aligned
        for i in range(sh.vec):
            out[:, at + i] = v[n][i]
            np.add.at(writes, at + i, 1)
    assert (writes == 1).all()  # every output value written exactly once
    if stats is not None:
        for key, val in worst.items():
            stats[key] = max(stats.get(key, 0), val)
    return out


def oracle(name, packed, base, width, dt):
    """The port's NumPy oracle."""
    if name == "unpack_orig":
        return ref.untranspose(ref.unpack(packed, width, dt), dt)
    deltas = ref.unpack(packed, width, dt)
    if name == "unzdelta_pack_orig":
        one = layout.np_dtype(dt).type(1)
        deltas = (deltas >> one) ^ (np.zeros_like(deltas) - (deltas & one))
    bases = np.broadcast_to(base, (packed.shape[0], layout.lanes(dt)))
    return ref.untranspose(ref.undelta(deltas, bases, dt), dt)


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("dt,w", CONFIGS)
def test_orig_model_matches_oracle_and_plain(dt, w, name):
    """The model on the first n blocks of one case for every block count n
    (per-block base), and on all of them with a shared base, against the
    oracle and the plain versions of the whole case (the blocks are
    independent, so the first n blocks of their output are the model's)."""
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    rng = np.random.default_rng(1000 * t + w)
    counts = Shape(dt).block_counts()
    n = counts[-1]
    packed = rng.integers(0, 1 << t, size=(n, layout.packed_len(dt, w)),
                          dtype=np.uint64).astype(np_dt)
    per_block = rng.integers(0, 1 << t, size=(n, nl), dtype=np.uint64).astype(np_dt)
    bases = [None] if name == "unpack_orig" else [per_block, per_block[-1].copy()]
    for base in bases:
        want = oracle(name, packed, base, w, dt)
        args = (torch.from_numpy(packed),) if base is None else (
            torch.from_numpy(packed), torch.from_numpy(base))
        plain = getattr(ck, name + "_plain")(*args, w, dt).numpy()
        assert want.dtype == plain.dtype and np.array_equal(want, plain)
        for m in counts if base is None or base.ndim == 2 else [n]:
            got = model_decode(name, packed[:m], None if base is None else base[:m]
                               if base.ndim == 2 else base, w, dt)
            assert got.dtype == want.dtype and np.array_equal(got, want[:m]), (m, base)


@pytest.mark.parametrize("dt", DTYPES)
def test_orig_model_bank_claims(dt):
    """What the kernel's comment says of its shared-memory accesses, at every
    width: a warp's copies take the fewest wavefronts their bytes need (u64:
    two for 256 bytes, u32: one for 128), and at most four distinct words
    meet in one bank (pair) in a warp's row loads; u64 two up to W = 33,
    u32 one at W = 1 and W = 32."""
    t = layout.bit_width(dt)
    by_width = {}
    for w in range(1, t + 1):
        stats = {}
        packed = np.zeros((1, layout.packed_len(dt, w)), layout.np_dtype(dt))
        model_decode("unpack_orig", packed, None, w, dt, stats)
        by_width[w] = stats
    assert {s["copy"] for s in by_width.values()} == {0}
    rows = {w: s["rows"] for w, s in by_width.items()}
    assert max(rows.values()) == 4, rows
    if dt == "u64":
        assert max(rows[w] for w in range(1, 34)) == 2, rows
    else:
        assert rows[1] == rows[32] == 1, rows
