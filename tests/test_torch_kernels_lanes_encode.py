"""A NumPy model of the per-thread arithmetic of the u8/u16 encode kernel
(`encode_kernel` in fastlanes_tpu_torch/csrc/codecs.cu), held bit for bit
(tolerance 0) against the port's NumPy oracle and its plain versions.

The counterpart of test_torch_kernels_lanes.py for the encode: a thread owns
PER adjacent lanes in one 32-bit word, loads each transposed row as one
word, subtracts (delta, FoR) and zigzags lane-wise, and packs with a shift
UP into the word in flight, so each row is cut to its lane before the shift
and the carried remainder is cut after it. In original order it loads its
lanes' consecutive values (u8: four 8-byte loads; u16: 16-byte halves and a
half swap between the thread pair) and turns them into row words with the
decode's byte transpose, which is its own inverse. The model follows the
kernel line by line on numpy uint32 arrays, one column per thread, and
counts every value word read and every packed and base word written."""

import numpy as np
import pytest
import torch

from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ref import numpy_ref as ref

from test_torch_kernels_lanes import U32, Lanes, Out, byte_perm, row_offset, seg

TRANSPOSED_OPS = ("pack", "delta_pack", "for_pack")
ORIG_OPS = ("delta_pack_orig", "delta_pack_orig_zigzag")
N_BLOCKS = 3


def cases():
    for dt in ("u8", "u16"):
        t = layout.bit_width(dt)
        for w in range(t + 1):
            for name in TRANSPOSED_OPS + ORIG_OPS:
                if w > 0 or name in ORIG_OPS:  # W = 0 has no packed words to launch for
                    yield dt, w, name


class Words(Out):
    """An output as (B, n) 32-bit words with a count of writes per word."""

    def __init__(self, n_blocks, n_words):
        self.words = np.zeros((n_blocks, n_words), U32)
        self.writes = np.zeros((n_blocks, n_words), np.int64)


class In:
    """The values as (B, 256) 32-bit words with a count of reads per word."""

    def __init__(self, values):
        self.words = np.ascontiguousarray(values).view(U32).reshape(values.shape[0], -1)
        self.reads = np.zeros(self.words.shape, np.int64)

    def load(self, index):
        """index: (32,) word index per thread -> (B, 32)."""
        np.add.at(self.reads, (slice(None), index), 1)
        return self.words[:, index]


def encode_rows(lanes, load, store, width, prev, reference, op):
    """encode_rows of codecs.cu over every thread at once: load(r) gives row
    r of each thread, (B, 32); store(w, v) writes packed word w."""
    t = lanes.tbits
    copy = width == t
    mask = lanes.low_bits(width)
    tmp = np.zeros(prev.shape, U32)
    word = shift = 0
    for r in range(t):
        src = load(r)
        if op in ("delta", "zdelta"):
            d = lanes.sub(src, prev)
            prev = src
            if op == "zdelta":
                d = lanes.zigzag(d)
            src = d
        elif op == "for":
            src = lanes.sub(src, reference)
        if copy:
            store(r, src)
            continue
        src = src & mask
        tmp = tmp | lanes.shift_in(src, shift)
        end = shift + width
        if end >= t:
            store(word, tmp)
            word += 1
            remaining = end - t
            tmp = lanes.carry(src, width, remaining)
            shift = remaining
        else:
            shift = end


def transpose_4x4(x):
    """The 4x4 byte transpose of store_original (codecs.cu): byte j of word
    i becomes byte i of word j."""
    t0, t1 = byte_perm(x[0], x[1], 0x5140), byte_perm(x[0], x[1], 0x7362)
    t2, t3 = byte_perm(x[2], x[3], 0x5140), byte_perm(x[2], x[3], 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def load_original(dt, values):
    """load_original of codecs.cu: the T row words of every thread."""
    q = np.arange(32)
    if dt == "u8":  # lane 4q+k: one 8-byte load (2 words) at seg*8 bytes
        w = [[values.load(np.array([seg(4 * int(x) + k, dt) * 2 for x in q]) + h)
              for h in range(2)] for k in range(4)]
        return [row for h in range(2) for row in transpose_4x4([w[k][h] for k in range(4)])]
    odd = (q & 1).astype(bool)
    p = q >> 1
    # 16 bytes of lane 4p+c: rows 0-7 for the even thread, rows 8-15 for the odd one
    at = [np.array([seg(4 * int(x) + c, dt) * 8 for x in p]) + np.where(odd, 4, 0)
          for c in range(4)]
    half = [[values.load(at[c] + i) for i in range(4)] for c in range(4)]
    w = [[None] * 8 for _ in range(2)]
    for k in range(2):
        for i in range(4):
            own = np.where(odd, half[2 + k][i], half[k][i])
            # __shfl_xor_sync(.., 1): thread q reads what thread q ^ 1 sent
            other = np.where(odd, half[k][i], half[2 + k][i])[:, q ^ 1]
            w[k][i] = np.where(odd, other, own)
            w[k][4 + i] = np.where(odd, own, other)
    rows = []
    for j in range(8):
        rows += [byte_perm(w[0][j], w[1][j], 0x5410), byte_perm(w[0][j], w[1][j], 0x7632)]
    return rows


def model_encode(name, values, param, width, dt):
    """encode_kernel<T, OP, ORDER> for u8/u16: (B, 1024) values -> (B, plen)
    packed words, and for delta_pack_orig also the (B, LANES) base it writes.
    param: a (LANES,) shared or (B, LANES) per-block base, or a scalar or
    (B,) per-block reference, read as the kernel reads them."""
    lanes = Lanes(dt)
    n_blocks, threads, per = values.shape[0], lanes.threads, lanes.per
    b = np.arange(n_blocks)[:, None]
    q = np.arange(threads)
    src = In(values)
    packed = Words(n_blocks, threads * width)

    def store(w, v):  # out32[b*THREADS*W + w*THREADS + q]
        packed.store(w * threads + q, v)

    prev = np.zeros((n_blocks, threads), U32)
    reference = U32(0)
    base = None
    if name in ORIG_OPS:
        rows = load_original(dt, src)
        base = Words(n_blocks, threads)
        base.store(q, rows[0])  # base32[b*THREADS + q]
        if width > 0:
            op = "zdelta" if name.endswith("_zigzag") else "delta"
            encode_rows(lanes, lambda r: rows[r], store, width, rows[0], reference, op)
    else:
        op = {"pack": "pack", "delta_pack": "delta", "for_pack": "for"}[name]
        if op == "delta":  # base32[b * (base_stride / PER) + q]
            base_stride = layout.lanes(dt) if param.ndim == 2 else 0
            base32 = np.ascontiguousarray(param).view(U32).reshape(-1)
            prev = base32[b * (base_stride // per) + q]
        elif op == "for":  # rep(ref[b * ref_stride]) or rep(the scalar)
            refs = np.broadcast_to(np.asarray(param, layout.np_dtype(dt)), (n_blocks,))
            reference = np.array([lanes.rep(x) for x in refs], U32)[:, None]
        encode_rows(lanes, lambda r: src.load(row_offset(r) // per + q), store, width,
                    prev, reference, op)
    assert (src.reads == 1).all()  # every value word read exactly once
    assert (packed.writes == 1).all()  # every packed word written exactly once
    np_dt = layout.np_dtype(dt)
    out = packed.words.view(np_dt).reshape(n_blocks, -1)
    if base is None:
        return out
    assert (base.writes == 1).all()
    return out, base.words.view(np_dt).reshape(n_blocks, layout.lanes(dt))


def oracle(name, values, param, width, dt):
    """The port's NumPy oracle; a per-block reference block by block."""
    if name == "pack":
        return ref.pack(values, width, dt)
    if name == "delta_pack":
        return ref.delta_pack(values, param, width, dt)
    if name == "for_pack":
        refs = np.broadcast_to(np.asarray(param), (values.shape[0],))
        return np.concatenate([ref.for_pack(values[i:i + 1], int(x), width, dt)
                               for i, x in enumerate(refs)])
    tr = ref.transpose(values, dt)
    base = tr[:, :layout.lanes(dt)]
    d = ref.delta(tr, base, dt)
    if name.endswith("_zigzag"):
        t = layout.bit_width(dt)
        np_dt = layout.np_dtype(dt)
        neg = (d >> np_dt.type(t - 1)) * np_dt.type((1 << t) - 1)
        d = (d << np_dt.type(1)) ^ neg
    return ref.pack(d, width, dt), base


def case(dt, w, seed):
    """Values over the whole range, with the lane extremes 0, 2^(T-1) - 1,
    2^(T-1) and 2^T - 1 in runs and next to each other, so that the
    lane-wise subtract and zigzag see their sign bit and their borrows."""
    rng = np.random.default_rng(seed)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    edges = np.array([0, (1 << (t - 1)) - 1, 1 << (t - 1), (1 << t) - 1], np.uint64)
    values = rng.integers(0, 1 << t, size=(N_BLOCKS, layout.BLOCK), dtype=np.uint64)
    values[0, ::3] = edges[rng.integers(0, 4, values[0, ::3].size)]
    values[1] = edges[np.arange(layout.BLOCK) % 4]
    bases = rng.integers(0, 1 << t, size=(N_BLOCKS, nl), dtype=np.uint64)
    bases[0] = edges[np.arange(nl) % 4]
    return values.astype(np_dt), bases.astype(np_dt)


@pytest.mark.parametrize("dt,w,name", list(cases()))
def test_encode_lane_model_matches_oracle_and_plain(dt, w, name):
    t = layout.bit_width(dt)
    values, bases = case(dt, w, 200 * t + w)
    if name == "for_pack":  # both extremes, and one reference per block
        params = [0, (1 << t) - 1, bases[:, 0].copy()]
    elif name == "delta_pack":
        params = [bases, bases[0].copy()]  # per-block and shared base
    else:
        params = [None]
    for param in params:
        got = model_encode(name, values, param, w, dt)
        want = oracle(name, values, param, w, dt)
        if name in ORIG_OPS:
            plain = ck.delta_pack_orig_plain(torch.from_numpy(values), w, dt,
                                             zigzag=name.endswith("_zigzag"))
        else:
            args = (torch.from_numpy(values),) if param is None else (
                torch.from_numpy(values),
                torch.from_numpy(param) if isinstance(param, np.ndarray) else param)
            plain = getattr(ck, name + "_plain")(*args, w, dt)
        for g, o, p in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want, plain))):
            assert g.dtype == o.dtype and np.array_equal(g, o), (name, param)
            assert np.array_equal(g, p.numpy()), (name, param)


@pytest.mark.parametrize("dt", ["u8", "u16"])
def test_encode_lane_model_helpers(dt):
    """sub, zigzag and the two halves of the pack step lane by lane against
    scalar arithmetic mod 2^T, over every lane value pair at the lane
    boundaries: no borrow, carry or shifted bit crosses into another lane."""
    lanes = Lanes(dt)
    t, per = lanes.tbits, lanes.per
    top = (1 << t) - 1
    edge = np.array([0, 1, 2, top // 2, top // 2 + 1, top - 1, top], np.uint64)
    a, b = (x.ravel() for x in np.meshgrid(edge, edge))

    def pack_lanes(x, y):  # x in the even lanes, y in the odd ones
        return sum(U32(int(v)) << U32(t * k) for k, v in enumerate([x, y] * (per // 2)))

    def lane(word, k):
        return (int(word) >> (t * k)) & top

    for x, y in zip(a, b):
        word, other = pack_lanes(x, y), pack_lanes(y, x)
        s, z = lanes.sub(word, other), lanes.zigzag(word)
        shifted = [lanes.shift_in(word, shift) for shift in range(t)]
        for k in range(per):
            xs, ys = (int(x), int(y)) if k % 2 == 0 else (int(y), int(x))
            assert lane(s, k) == (xs - ys) & top
            assert lane(z, k) == ((xs << 1) & top) ^ (top if xs >> (t - 1) else 0)
            for shift in range(t):
                assert lane(shifted[shift], k) == (xs << shift) & top
            for width in range(1, t):
                cut = word & lanes.low_bits(width)  # the row as the pack step holds it
                for remaining in range(width):
                    assert lane(lanes.carry(cut, width, remaining), k) == \
                        (xs & ((1 << width) - 1)) >> (width - remaining)
