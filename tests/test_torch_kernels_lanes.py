"""A NumPy model of the per-thread arithmetic of the u8/u16 decode kernels
(`decode_kernel` in fastlanes_tpu_torch/csrc/codecs.cu), held bit for bit
(tolerance 0) against the port's NumPy oracle and its plain versions.

The CUDA kernel does not run on the CPU. What can go wrong in it beyond the
plain version's arithmetic is its index and bit arithmetic: PER lanes in one
32-bit word, masks replicated into every lane, the stitch of a row that
straddles two words, lane-wise adds and unzigzag, and in original order the
byte transpose and where each word lands. The model below follows the
kernel's code line by line on numpy uint32 arrays, one column per thread
(32 threads a FastLanes block), and writes through the same word addresses,
counting the writes."""

import numpy as np
import pytest
import torch

from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ops import orig as ops_orig
from fastlanes_tpu_torch.ref import numpy_ref as ref

U32 = np.uint32
TRANSPOSED_OPS = ("unpack", "unfor_pack", "undelta_pack", "unzdelta_pack")
ORIG_OPS = ("unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig")
CONFIGS = [(dt, w) for dt in ("u8", "u16") for w in range(layout.bit_width(dt) + 1)]
N_BLOCKS = 3


class Lanes:
    """Lanes<T> of codecs.cu for T narrower than 32 bits."""

    def __init__(self, dt):
        self.tbits = layout.bit_width(dt)
        self.per = 32 // self.tbits
        self.threads = layout.lanes(dt) // self.per
        self.ones = U32(0xFFFFFFFF // ((1 << self.tbits) - 1))
        self.high = U32(int(self.ones) << (self.tbits - 1))
        self.lane_max = U32((1 << self.tbits) - 1)

    def low_bits(self, k):
        return U32(((1 << k) - 1) * int(self.ones))

    def rep(self, x):
        return U32(int(x) * int(self.ones))

    def add(self, a, b):
        lo = ~self.high
        return ((a & lo) + (b & lo)) ^ ((a ^ b) & self.high)

    def unzigzag(self, v):
        return ((v >> U32(1)) & ~self.high) ^ ((v & self.ones) * self.lane_max)

    def stitch(self, v, nxt, shift, remaining):
        t = self.tbits
        return (v & self.low_bits(t - shift)) | (
            (nxt & self.low_bits(remaining)) << U32(t - shift))

    # the encode's helpers
    def sub(self, a, b):
        return ((a | self.high) - (b & ~self.high)) ^ ((a ^ ~b) & self.high)

    def zigzag(self, d):
        return ((d << U32(1)) & ~self.ones) ^ (
            ((d >> U32(self.tbits - 1)) & self.ones) * self.lane_max)

    def shift_in(self, src, shift):
        return (src & self.low_bits(self.tbits - shift)) << U32(shift)

    def carry(self, src, width, remaining):
        return (src >> U32(width - remaining)) & self.low_bits(remaining)


def decode_rows(lanes, p, width, acc, reference, op):
    """decode_rows of codecs.cu over every thread at once: p is (B, W, 32),
    word w of thread q at p[:, w, q]; returns the T row words (B, 32)."""
    t = lanes.tbits
    mask = lanes.low_bits(width)
    src = p[:, 0] if width > 0 else np.zeros(acc.shape, U32)
    word = shift = 0
    rows = []
    for _ in range(t):
        v = np.zeros(acc.shape, U32)
        if width > 0:
            v = src >> U32(shift)
            end = shift + width
            if end >= t:
                remaining = end - t
                word += 1
                if word < width:
                    src = p[:, word]
                    if remaining > 0:
                        v = lanes.stitch(v, src, shift, remaining)
                shift = remaining
            else:
                shift = end
            v = v & mask
        if op == "unfor":
            v = lanes.add(v, reference)
        elif op == "unzdelta":
            v = lanes.unzigzag(v)
        if op in ("undelta", "unzdelta"):
            acc = lanes.add(acc, v)
            v = acc
        rows.append(v)
    return rows


def fl_order(o):
    return ((o & 1) << 2) | (o & 2) | ((o >> 2) & 1)


def row_offset(r):
    return (r % 8) * 128 + fl_order(r // 8) * 16


def seg(lane, dt):
    """Orig<T>::seg of codecs.cu."""
    t = layout.bit_width(dt)
    return (lane & 15) * (64 // t) + fl_order(lane >> 4) // (t // 8)


def byte_perm(x, y, selector):
    """__byte_perm(x, y, s): byte n of the result is byte (s >> 4n) & 7 of
    the eight bytes y:x (x bytes 0-3, y bytes 4-7)."""
    pool = [(x >> U32(8 * i)) & U32(0xFF) for i in range(4)] + \
           [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros(np.shape(x), U32)
    for n in range(4):
        out |= pool[(selector >> (4 * n)) & 7] << U32(8 * n)
    return out


class Out:
    """The output block as 32-bit words, with a count of writes per word."""

    def __init__(self, n_blocks, per):
        self.words = np.zeros((n_blocks, layout.BLOCK // per), U32)
        self.writes = np.zeros((n_blocks, layout.BLOCK // per), np.int64)

    def store(self, index, value):
        """index: (32,) word index per thread; value: (B, 32)."""
        self.words[:, index] = value
        np.add.at(self.writes, (slice(None), index), 1)


def store_original(dt, rows, out):
    q = np.arange(32)
    if dt == "u8":
        w = [[None, None] for _ in range(4)]
        for h in range(2):
            r = rows[4 * h:4 * h + 4]
            t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
            t2, t3 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
            w[0][h], w[1][h] = byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632)
            w[2][h], w[3][h] = byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)
        for k in range(4):
            at = np.array([seg(4 * int(x) + k, dt) * 2 for x in q])  # uint2 = 2 words
            out.store(at, w[k][0])
            out.store(at + 1, w[k][1])
        return
    w = [[byte_perm(rows[2 * j], rows[2 * j + 1], sel) for j in range(8)]
         for sel in (0x5410, 0x7632)]
    odd = (q & 1).astype(bool)
    own = [[np.where(odd, w[k][4 + i], w[k][i]) for i in range(4)] for k in range(2)]
    # __shfl_xor_sync(.., 1): thread q reads what thread q ^ 1 sent
    other = [[np.where(odd, w[k][i], w[k][4 + i])[:, q ^ 1] for i in range(4)]
             for k in range(2)]
    p = q >> 1
    for c in range(4):
        k = c & 1
        mine = (c < 2) != odd
        at = np.array([seg(4 * int(x) + c, dt) * 8 for x in p]) + np.where(odd, 4, 0)
        for i in range(4):  # uint4 at u16 offset seg*16 + 8*odd = 4 words
            out.store(at + i, np.where(mine, own[k][i], other[k][i]))


def model_decode(name, packed, param, width, dt):
    """decode_kernel<T, OP, ORDER> for u8/u16: (B, plen) packed -> (B, 1024).
    param: a (LANES,) shared or (B, LANES) per-block base, or a scalar or
    (B,) per-block reference, read as the kernel reads them."""
    lanes = Lanes(dt)
    n_blocks = packed.shape[0]
    p = np.ascontiguousarray(packed).view(U32).reshape(n_blocks, width, lanes.threads)
    op = name.replace("_orig", "").replace("_pack", "")
    b = np.arange(n_blocks)[:, None]
    q = np.arange(lanes.threads)
    acc = np.zeros((n_blocks, lanes.threads), U32)
    reference = U32(0)
    if op in ("undelta", "unzdelta"):  # base32[b * (base_stride / PER) + q]
        base_stride = layout.lanes(dt) if param.ndim == 2 else 0
        base32 = np.ascontiguousarray(param).view(U32).reshape(-1)
        acc = base32[b * (base_stride // lanes.per) + q]
    elif op == "unfor":  # rep(ref[b * ref_stride]) or rep(the scalar)
        refs = np.broadcast_to(np.asarray(param, layout.np_dtype(dt)), (n_blocks,))
        reference = np.array([lanes.rep(x) for x in refs], U32)[:, None]
    rows = decode_rows(lanes, p, width, acc, reference, op)
    out = Out(n_blocks, lanes.per)
    if name.endswith("_orig"):
        store_original(dt, rows, out)
    else:
        for r, v in enumerate(rows):
            out.store(row_offset(r) // lanes.per + q, v)
    assert (out.writes == 1).all()  # every output word written exactly once
    return out.words.view(layout.np_dtype(dt)).reshape(n_blocks, layout.BLOCK)


def oracle(name, packed, param, width, dt):
    """The port's NumPy oracle; a per-block reference block by block."""
    if name.startswith("unfor"):
        refs = np.broadcast_to(np.asarray(param), (packed.shape[0],))
        return np.concatenate([ref.unfor_pack(packed[i:i + 1], int(x), width, dt)
                               for i, x in enumerate(refs)])
    if name.startswith("unpack"):
        out = ref.unpack(packed, width, dt)
    else:
        base = np.broadcast_to(param, (packed.shape[0], layout.lanes(dt)))
        deltas = ref.unpack(packed, width, dt)
        if name.startswith("unzdelta"):
            one = layout.np_dtype(dt).type(1)
            deltas = (deltas >> one) ^ (np.zeros_like(deltas) - (deltas & one))
        out = ref.undelta(deltas, base, dt)
    return ref.untranspose(out, dt) if name.endswith("_orig") else out


def case(dt, w, seed):
    rng = np.random.default_rng(seed)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    packed = rng.integers(0, 1 << t, size=(N_BLOCKS, layout.packed_len(dt, w)),
                          dtype=np.uint64).astype(np_dt)
    bases = rng.integers(0, 1 << t, size=(N_BLOCKS, nl), dtype=np.uint64).astype(np_dt)
    return packed, bases


@pytest.mark.parametrize("name", TRANSPOSED_OPS + ORIG_OPS)
@pytest.mark.parametrize("dt,w", CONFIGS)
def test_lane_model_matches_oracle_and_plain(dt, w, name):
    t = layout.bit_width(dt)
    packed, bases = case(dt, w, 100 * t + w)
    if name == "unfor_pack":  # both extremes, and one reference per block
        params = [0, (1 << t) - 1, bases[:, 0].copy()]
    elif name in ("unpack", "unpack_orig"):
        params = [None]
    else:
        params = [bases, bases[0].copy()]  # per-block and shared base
    for param in params:
        got = model_decode(name, packed, param, w, dt)
        want = oracle(name, packed, param, w, dt)
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, param)
        args = (torch.from_numpy(packed),) if param is None else (
            torch.from_numpy(packed),
            torch.from_numpy(param) if isinstance(param, np.ndarray) else param)
        plain = getattr(ck, name + "_plain")(*args, w, dt)
        assert np.array_equal(got, plain.numpy()), (name, param)


@pytest.mark.parametrize("dt", ["u8", "u16"])
def test_lane_model_helpers(dt):
    """The SWAR helpers lane by lane against scalar arithmetic mod 2^T, over
    every lane value pair at the lane boundaries, and seg() against the
    port's own table of where a lane's rows lie in original order."""
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
        s, z = lanes.add(word, other), lanes.unzigzag(word)
        for k in range(per):
            xs, ys = (int(x), int(y)) if k % 2 == 0 else (int(y), int(x))
            assert lane(s, k) == (xs + ys) & top
            assert lane(z, k) == ((xs >> 1) ^ (-(xs & 1) & top))
    assert lanes.low_bits(t) == U32(0xFFFFFFFF) and lanes.low_bits(0) == U32(0)
    assert tuple(seg(lane_, dt) for lane_ in range(layout.lanes(dt))) == \
        ops_orig._seg_of_lane(dt)
