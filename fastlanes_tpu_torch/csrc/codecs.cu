// FastLanes codec kernels for NVIDIA Hopper (sm_90a).
//
// Eleven kernels from two row loops. Seven are the CUDA counterparts of the
// kernels that fastlanes_tpu/kernels/pallas_codecs.py builds from
// _unpack_body and _pack_body: unpack (:635), unfor_pack (:721),
// undelta_pack (:656), unzdelta_pack (:674) (decode_kernel) and pack,
// delta_pack, for_pack (encode_kernel), all in TRANSPOSED order. Four read or
// write ORIGINAL order in the same pass: unpack_orig, undelta_pack_orig,
// unzdelta_pack_orig (decode_kernel for u8/u16, decode_orig_kernel for
// u32/u64; the in-kernel relayout that benchmarks/exp_untranspose_pallas.py
// tried on the TPU, _kernel_pD :164, _kernel_pE :171, _kernel_pG :267, whose
// compiler refused it; the zigzag hook of pallas_codecs.py:841) and
// delta_pack_orig, plain and zigzag (encode_kernel for u8/u16,
// encode_orig_kernel for u32/u64).
//
// Layout facts the design rests on (core/layout.py): packed word w of lane l
// of block b is packed[b*plen + LANES*w + l] with plen = LANES*W, and row r
// of lane l of the transposed-order block is values[b*1024 + row_offset(r) + l]
// with row_offset(r) = (r%8)*128 + FL_ORDER[r/8]*16. In ORIGINAL order the T
// rows of a lane are contiguous: row r of lane l is values[b*1024 + seg(l)*T + r],
// seg a permutation of the lanes (Orig<T>::seg).
//
// These kernels move B*(1024*W/8 + 1024*T/8) bytes (plus B*LANES*T/8 for a
// per-block base) and do a handful of integer operations per value, far
// below the card's compute/bandwidth line: memory traffic bounds them, and a
// kernel reaches that bound only if every warp-wide load and store moves
// whole 32-byte sectors, 128 bytes or more per instruction.
//
// Decode (decode_kernel) and encode (encode_kernel), both orders for u8/u16
// and transposed order for u32/u64: one thread owns PER = 4 / sizeof(T)
// ADJACENT lanes of one block for T narrower than 32 bits (4 for u8, 2 for
// u16), else one lane (Lanes<T>). Those PER lanes are one aligned 32-bit word
// in every word group, base row and transposed row, so the thread loads and
// stores its packed words, its base and, in transposed order, each row as
// 32-bit words: a FastLanes block is one warp of 32 threads (u64: 16) and
// each warp-wide access is 128 contiguous bytes for every dtype. With one
// lane per thread a u8 warp moved 32 bytes per instruction, 4x the
// instructions per byte, and reached a third of the bound. The row loops run
// lane-wise on the 32-bit word (SWAR): masks are the W-bit mask replicated
// into every lane; the decode's straddling row masks both parts to their lane
// before it joins them, and the encode cuts each row to its lane before it
// shifts it UP into the word in flight and cuts the carried remainder after
// shifting it down; adds (unfor, running sum) and subtracts (delta, FoR)
// treat each lane's top bit apart so that no carry or borrow crosses into
// the next lane; unzigzag and zigzag mask the bit that their shift brings in
// from the next lane. The split into PER scalar registers would run the
// scalar loop PER times over; SWAR costs a few operations per row for all
// PER lanes at once. For u32/u64 (PER = 1) every helper is the scalar
// operation of the one-lane loop.
//
// In original order a lane's T rows are T consecutive values. A u8/u16
// thread keeps its T row words in registers and turns them with a 4x4 (u8)
// or 2x2 (u16) byte transpose (__byte_perm) into words of 4 (2) consecutive
// values of one lane; both transposes are their own inverses, so the encode
// loads what the decode stores and turns it back the same way. u8: the 8 rows
// of a lane are 8 bytes, one 8-byte access; the warp's accesses for one lane
// index cover four 64-byte runs. u16: the 16 rows of a lane are 32 bytes, one
// sector; the thread pair (2p, 2p+1) swaps halves with one shuffle per word,
// so that in each 16-byte access the pair covers both halves of the same lane
// and the warp covers four 128-byte lines. Nothing is staged and no thread
// waits at a barrier. For u32/u64 a lane's 32 (64) rows are 128 (512) bytes,
// which one thread cannot move as a whole. decode_orig_kernel is
// output-stationary: a CUDA block copies its blocks' packed words into
// shared memory lane-major, each thread computes 4 rows of one lane straight
// from them and stores them as 16-byte runs, and a lane's running sum is a
// scan over its threads. encode_orig_kernel stages the block's values in
// shared memory and moves them in with consecutive threads on consecutive
// words.
//
// The bit width W is a run-time argument (one instantiation per dtype, op
// and order). A shift by T is undefined in C++, so the W-bit mask, the
// W == T copy and the word-boundary stitch are guarded, and every shift of a
// uint8_t/uint16_t (which promotes to int) is truncated with T(...). Decode
// handles every W in [0, T]; transposed-order encode every W in [1, T]
// (W == 0 has no output words, so there is nothing to launch);
// original-order encode also W == 0, where it writes only the base.
//
// Plain C interface for ctypes; no PyTorch headers. The entries launch on the
// stream they are given, allocate nothing, do not synchronise, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

enum Op { OP_UNPACK = 0, OP_UNFOR = 1, OP_UNDELTA = 2, OP_UNZDELTA = 3 };
enum EncodeOp { ENC_PACK = 0, ENC_DELTA = 1, ENC_FOR = 2, ENC_ZDELTA = 3 };
enum Order { ORDER_TRANSPOSED = 0, ORDER_ORIG = 1 };

constexpr int kThreads = 256;

// FL_ORDER = (0, 4, 2, 6, 1, 5, 3, 7) is the 3-bit reversal of its index.
__host__ __device__ constexpr int fl_order(int o) {
    return ((o & 1) << 2) | (o & 2) | ((o >> 2) & 1);
}

__host__ __device__ constexpr int row_offset(int r) {
    return (r % 8) * 128 + fl_order(r / 8) * 16;
}

// What one thread holds: PER adjacent lanes of one FastLanes block in one
// register V (a 32-bit word for u8/u16, T itself for u32/u64), and the
// lane-wise operations of the row loops on it. For PER = 1 each operation is
// the scalar one.
template <typename T>
struct Lanes {
    static constexpr int TBITS = sizeof(T) * 8;
    static constexpr int LANES = 1024 / TBITS;
    using V = typename std::conditional<(sizeof(T) < 4), uint32_t, T>::type;
    static constexpr int PER = sizeof(V) / sizeof(T);  // lanes per thread
    static constexpr int THREADS = LANES / PER;        // threads per FastLanes block
    static constexpr V ONES = V(~V(0)) / V(T(~T(0)));  // 0x01010101, 0x00010001, 1
    static constexpr V HIGH = V(ONES << (TBITS - 1));  // the top bit of every lane

    // the low k bits of every lane, k in [0, TBITS]; for PER > 1 the shift
    // stays below 32, so k = TBITS needs no guard
    __device__ __forceinline__ static V low_bits(int k) {
        if constexpr (PER == 1) return k == TBITS ? V(~V(0)) : V((V(1) << k) - V(1));
        else return V((V(1) << k) - V(1)) * ONES;
    }
    __device__ __forceinline__ static V rep(T x) { return V(V(x) * ONES); }
    // wrapping add in every lane: the top bits are added apart (xor), so no
    // carry leaves a lane
    __device__ __forceinline__ static V add(V a, V b) {
        if constexpr (PER == 1) return V(a + b);
        else return V(((a & ~HIGH) + (b & ~HIGH)) ^ ((a ^ b) & HIGH));
    }
    // (v >> 1) ^ -(v & 1) in every lane; the shift brings the next lane's low
    // bit into the top bit, which the mask clears
    __device__ __forceinline__ static V unzigzag(V v) {
        if constexpr (PER == 1) return V(V(v >> 1) ^ V(V(0) - V(v & V(1))));
        else return V(((v >> 1) & ~HIGH) ^ ((v & ONES) * V(T(~T(0)))));
    }
    // the row that straddles two words: v = src >> shift holds the lane's
    // TBITS - shift high bits of the old word, `next` gives the `remaining`
    // low bits of the new one, shifted up by TBITS - shift. With PER > 1 both
    // parts are first cut to their lane, so no bits cross between lanes.
    __device__ __forceinline__ static V stitch(V v, V next, int shift, int remaining) {
        if constexpr (PER == 1) return V(v | V(next << (TBITS - shift)));
        else return V((v & low_bits(TBITS - shift)) |
                      ((next & low_bits(remaining)) << (TBITS - shift)));
    }

    // The encode's operations.
    // wrapping subtract in every lane: the top bit of a is set and that of b
    // cleared, so no lane borrows from the next; the xor then gives each
    // lane's top bit its true value, a ^ b ^ borrow
    __device__ __forceinline__ static V sub(V a, V b) {
        if constexpr (PER == 1) return V(a - b);
        else return V(((a | HIGH) - (b & ~HIGH)) ^ ((a ^ ~b) & HIGH));
    }
    // (d << 1) ^ (d >> (T-1)) with the arithmetic shift in every lane; the
    // left shift brings the lane below's top bit into bit 0, which the mask
    // clears
    __device__ __forceinline__ static V zigzag(V d) {
        if constexpr (PER == 1) {
            using S = typename std::make_signed<T>::type;
            return V(V(d << 1) ^ V(S(d) >> (TBITS - 1)));
        } else {
            return V(((d << 1) & ~ONES) ^ (((d >> (TBITS - 1)) & ONES) * V(T(~T(0)))));
        }
    }
    // the row (cut to W bits) at bit `shift` of the word in flight: with
    // PER > 1 only its TBITS - shift low bits fit in the lane, the rest is cut
    // before the shift so that it does not reach the lane above
    __device__ __forceinline__ static V shift_in(V src, int shift) {
        if constexpr (PER == 1) return V(src << shift);
        else return V((src & low_bits(TBITS - shift)) << shift);
    }
    // the `remaining` high bits of a W-bit row that did not fit, which open
    // the next word; with PER > 1 the lane above's low bits that the shift
    // brings down are cut. width - remaining is in [1, W] and W < TBITS.
    __device__ __forceinline__ static V carry(V src, int width, int remaining) {
        if constexpr (PER == 1) return V(src >> (width - remaining));
        else return V((src >> (width - remaining)) & low_bits(remaining));
    }
};

// Where original order keeps a lane's rows (seg, every dtype), and the shape
// of the staged original-order encode of u32/u64 (encode_orig_kernel). A
// CUDA block of THREADS threads holds NB FastLanes blocks in shared memory,
// each as LANES segments of T values padded by one element
// (SEG_PITCH = T + 1): with that pitch neither the lane-major reads of the
// row loop (a warp touches one row of 32 segments) nor the row-major writes
// of the copy (a warp walks along segments) meet in one bank. u64 takes 64
// threads so that the stage stays at 33 KB; u32 takes 256 (33.8 KB). The
// copy moves one value of 4 or 8 bytes a step, so a warp moves 128 bytes or
// more per instruction.
template <typename T>
struct Orig {
    static constexpr int TBITS = sizeof(T) * 8;
    static constexpr int LANES = 1024 / TBITS;
    static constexpr int THREADS = sizeof(T) == 8 ? 64 : 256;
    static constexpr int NB = THREADS / LANES;
    static constexpr int SEG_PITCH = TBITS + 1;
    static constexpr int BLOCK_PITCH = LANES * SEG_PITCH;

    // The segment of original order that holds the T rows of `lane`:
    // (lane % 16) * (64 / T) + bitreverse(lane / 16), the reversal taken over
    // the log2(64 / T) bits that lane / 16 has.
    __host__ __device__ static constexpr int seg(int lane) {
        return (lane & 15) * (64 / TBITS) + (fl_order(lane >> 4) / (TBITS / 8));
    }
    // Where value j of FastLanes block fb of the CUDA block lies in the stage.
    __device__ static constexpr int staged(int fb, int j) {
        return fb * BLOCK_PITCH + (j / TBITS) * SEG_PITCH + j % TBITS;
    }
};

// The stores of the decode row loop: where row r of the thread's lanes goes.
template <typename T>
struct StoreTransposed {  // out + b*1024 + PER*q: one row = 128 contiguous bytes a warp
    using V = typename Lanes<T>::V;
    V* o;
    __device__ __forceinline__ void operator()(int r, V v) {
        o[row_offset(r) / Lanes<T>::PER] = v;
    }
};

template <typename T>
struct Rows {  // the T row words, kept in registers for the byte transpose
    using V = typename Lanes<T>::V;
    V rows[Lanes<T>::TBITS];
    __device__ __forceinline__ void operator()(int r, V v) { rows[r] = v; }  // decode: store
    __device__ __forceinline__ V operator()(int r) const { return rows[r]; }  // encode: load
};

// The decode row loop of one thread's PER lanes: p points at their first
// packed word (stride THREADS between words, in units of V); `acc` seeds the
// running sum of the delta ops, `reference` (replicated) is added by OP_UNFOR.
template <typename T, int OP, typename Store>
__device__ __forceinline__ void decode_rows(const typename Lanes<T>::V* __restrict__ p,
                                            int width, typename Lanes<T>::V acc,
                                            typename Lanes<T>::V reference, Store& store) {
    using L = Lanes<T>;
    using V = typename L::V;
    constexpr int TBITS = L::TBITS;
    const V mask = L::low_bits(width);
    V src = width > 0 ? p[0] : V(0);
    int word = 0;   // index of the packed word held in src
    int shift = 0;  // bit position of the next row inside src, < TBITS

#pragma unroll
    for (int r = 0; r < TBITS; ++r) {
        V v = V(0);
        if (width > 0) {
            v = V(src >> shift);
            const int end = shift + width;
            if (end >= TBITS) {
                // the row ends at or beyond the word boundary: fetch the next
                // word (none after the last row) and stitch its low bits in
                const int remaining = end - TBITS;
                ++word;
                if (word < width) {
                    src = p[(long long)word * L::THREADS];
                    if (remaining > 0) v = L::stitch(v, src, shift, remaining);
                }
                shift = remaining;
            } else {
                shift = end;
            }
            v = V(v & mask);
        }
        if (OP == OP_UNFOR) {
            v = L::add(v, reference);
        } else if (OP == OP_UNZDELTA) {
            v = L::unzigzag(v);
        }
        if (OP == OP_UNDELTA || OP == OP_UNZDELTA) {
            acc = L::add(acc, v);
            v = acc;
        }
        store(r, v);
    }
}

// The 4x4 byte transpose of a u8 thread: byte j of word x[i] becomes byte i
// of word y[j]. With rows 4h..4h+3 as x (byte l of a row word is lane 4q+l)
// it gives each lane one word of its rows 4h..4h+3, and back: it is its own
// inverse.
__device__ __forceinline__ void transpose_4x4(uint32_t x0, uint32_t x1, uint32_t x2,
                                              uint32_t x3, uint32_t* y) {
    const uint32_t t0 = __byte_perm(x0, x1, 0x5140);  // x0b0 x1b0 x0b1 x1b1
    const uint32_t t1 = __byte_perm(x0, x1, 0x7362);  // x0b2 x1b2 x0b3 x1b3
    const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
    const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
    y[0] = __byte_perm(t0, t2, 0x5410);  // x0b0 x1b0 x2b0 x3b0
    y[1] = __byte_perm(t0, t2, 0x7632);
    y[2] = __byte_perm(t1, t3, 0x5410);
    y[3] = __byte_perm(t1, t3, 0x7632);
}

// Original order from the row words of a u8 thread (lanes 4q..4q+3): the
// transposes of rows 0-3 and 4-7 give each lane its 8 rows (8 consecutive
// values), one 8-byte store into its segment. For one k the warp's stores
// fill four 64-byte runs.
__device__ __forceinline__ void store_original(const uint32_t (&rows)[8], uint8_t* out, int q) {
    uint32_t w[2][4];  // w[h][k]: rows 4h..4h+3 of lane 4q+k
#pragma unroll
    for (int h = 0; h < 2; ++h)
        transpose_4x4(rows[4 * h], rows[4 * h + 1], rows[4 * h + 2], rows[4 * h + 3], w[h]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        *reinterpret_cast<uint2*>(out + Orig<uint8_t>::seg(4 * q + k) * 8) =
            make_uint2(w[0][k], w[1][k]);
    }
}

// The encode's way back: lane 4q+k's 8 values are one 8-byte load from its
// segment, and the same transposes give the 8 row words.
__device__ __forceinline__ void load_original(const uint8_t* in, int q, uint32_t (&rows)[8]) {
    uint2 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        v[k] = *reinterpret_cast<const uint2*>(in + Orig<uint8_t>::seg(4 * q + k) * 8);
    transpose_4x4(v[0].x, v[1].x, v[2].x, v[3].x, rows);
    transpose_4x4(v[0].y, v[1].y, v[2].y, v[3].y, rows + 4);
}

// The same for a u16 thread (lanes 2q, 2q+1): a 2x2 transpose of rows 2j,
// 2j+1 gives word j of each lane, 8 words = the lane's 16 rows = 32 bytes,
// one sector. Threads 2p and 2p+1 swap halves (one shuffle per word): the
// even one then holds rows 0-7 of lanes 4p..4p+3, the odd one rows 8-15, and
// store c of the pair writes the whole sector of lane 4p + c; the warp's
// 16-byte stores cover four 128-byte lines. The whole warp is one FastLanes
// block, so the shuffle meets no thread that left.
__device__ __forceinline__ void store_original(const uint32_t (&rows)[16], uint16_t* out,
                                               int q) {
    uint32_t w[2][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        w[0][j] = __byte_perm(rows[2 * j], rows[2 * j + 1], 0x5410);
        w[1][j] = __byte_perm(rows[2 * j], rows[2 * j + 1], 0x7632);
    }
    const bool odd = q & 1;
    uint32_t own[2][4], other[2][4];  // rows of the half this thread stores
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            own[k][i] = odd ? w[k][4 + i] : w[k][i];
            other[k][i] = __shfl_xor_sync(0xffffffffu, odd ? w[k][i] : w[k][4 + i], 1);
        }
    }
    // lanes 4p, 4p+1 are the even thread's, 4p+2, 4p+3 the odd one's
    const int p = q >> 1;
    uint16_t* o = out + (odd ? 8 : 0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int k = c & 1;
        const bool mine = (c < 2) != odd;  // value selects: the arrays stay in registers
        *reinterpret_cast<uint4*>(o + Orig<uint16_t>::seg(4 * p + c) * 16) = make_uint4(
            mine ? own[k][0] : other[k][0], mine ? own[k][1] : other[k][1],
            mine ? own[k][2] : other[k][2], mine ? own[k][3] : other[k][3]);
    }
}

// The encode's way back for a u16 thread: the pair's 16-byte loads c fill
// the sector of lane 4p + c (the even thread loads rows 0-7, the odd one rows
// 8-15), the half swap gives each thread all 16 rows of its own two lanes,
// and the 2x2 transposes give the 16 row words.
__device__ __forceinline__ void load_original(const uint16_t* in, int q, uint32_t (&rows)[16]) {
    const bool odd = q & 1;
    const int p = q >> 1;
    const uint16_t* i0 = in + (odd ? 8 : 0);
    uint32_t half[4][4];  // half[c][i]: word i of this thread's half of lane 4p+c
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(i0 + Orig<uint16_t>::seg(4 * p + c) * 16);
        half[c][0] = v.x;
        half[c][1] = v.y;
        half[c][2] = v.z;
        half[c][3] = v.w;
    }
    uint32_t w[2][8];  // w[k][j]: rows 2j, 2j+1 of lane 2q+k
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // lanes 4p, 4p+1 are the even thread's, 4p+2, 4p+3 the odd one's
            const uint32_t own = odd ? half[2 + k][i] : half[k][i];
            const uint32_t other =
                __shfl_xor_sync(0xffffffffu, odd ? half[k][i] : half[2 + k][i], 1);
            w[k][i] = odd ? other : own;
            w[k][4 + i] = odd ? own : other;
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        rows[2 * j] = __byte_perm(w[0][j], w[1][j], 0x5410);
        rows[2 * j + 1] = __byte_perm(w[0][j], w[1][j], 0x7632);
    }
}

// The per-thread parameters of the hooks. The reference of OP_UNFOR / ENC_FOR
// is read at ref[b*ref_stride] (1 = one per block) or, with ref == nullptr,
// is the by-value scalar: a scalar costs no device memory and no copy.
template <typename T>
__device__ __forceinline__ T reference_of(const T* __restrict__ ref, long long ref_stride,
                                          T reference, long long b) {
    return ref != nullptr ? ref[b * ref_stride] : reference;
}

// Decode with PER lanes a thread, THREADS threads a FastLanes block: every
// op in transposed order, and for u8/u16 the original-order ops, whose rows
// leave through store_original. The thread reads its packed words and its
// base as 32-bit words (or T for u32/u64), so both must be 4-byte aligned.
template <typename T, int OP, int ORDER>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ packed, T* __restrict__ out,
              const T* __restrict__ base, long long base_stride,
              const T* __restrict__ ref, long long ref_stride, T reference,
              long long n_blocks, int width) {
    using L = Lanes<T>;
    using V = typename L::V;

    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long b = gid / L::THREADS;
    const int q = (int)(gid % L::THREADS);
    if (b >= n_blocks) return;  // ragged last CUDA block: whole warps leave

    const V* p = reinterpret_cast<const V*>(packed) + b * ((long long)L::THREADS * width) + q;
    V acc = V(0);
    if (OP == OP_UNDELTA || OP == OP_UNZDELTA)
        acc = reinterpret_cast<const V*>(base)[b * (base_stride / L::PER) + q];
    V rf = V(0);
    if (OP == OP_UNFOR) rf = L::rep(reference_of(ref, ref_stride, reference, b));

    if constexpr (ORDER == ORDER_TRANSPOSED) {
        StoreTransposed<T> store{reinterpret_cast<V*>(out) + b * (1024 / L::PER) + q};
        decode_rows<T, OP>(p, width, acc, rf, store);
    } else {
        static_assert(L::PER > 1, "u32/u64 decode to original order in decode_orig_kernel");
        Rows<T> rows;
        decode_rows<T, OP>(p, width, acc, rf, rows);
        store_original(rows.rows, out + b * 1024, q);
    }
}

// The shape of the output-stationary original-order decode (decode_orig_kernel):
// NB FastLanes blocks a CUDA block of THREADS threads, ROWS rows of one lane a
// thread, TPL threads a lane. A thread's rows leave in NS 16-byte stores of
// VEC consecutive values; store s of thread j holds rows
// s * (T / NS) + VEC * j + i, i < VEC, so that for each s the TPL threads of a
// lane store one contiguous run of its segment: u64 (TPL 16, NS 2) two runs
// of 256 bytes a lane, u32 (TPL 8, NS 1) the lane's whole 128 bytes.
// The packed words of each block wait in shared memory LANE-major, PITCH
// words a lane: 16.6 KB (u64) or 16.9 KB (u32) for the NB blocks.
template <typename T>
struct OrigOut {
    static constexpr int TBITS = sizeof(T) * 8;
    static constexpr int LANES = 1024 / TBITS;
    static constexpr int THREADS = 256;
    static constexpr int NB = 16 / (int)sizeof(T);
    static constexpr int ROWS = 1024 / THREADS;
    static constexpr int TPL = TBITS / ROWS;
    static constexpr int VEC = 16 / (int)sizeof(T);
    static constexpr int NS = ROWS / VEC;
    static constexpr int PITCH = TBITS + 1;
    static constexpr int COPIES = 1024 / THREADS;  // a thread's copies of a block's words
    static constexpr int MIN_CTAS = 8;             // 32 registers a thread: 64 warps an SM

    __host__ __device__ static constexpr int row(int s, int j, int i) {
        return s * (TBITS / NS) + VEC * j + i;
    }
};

// Bits [s, s + T) of the word pair hi:lo, s in [0, T): one funnel shift for
// u32; for u64 the high word is shifted up in two steps, so that s = 0 shifts
// it out whole instead of by T.
__device__ __forceinline__ uint32_t funnel_right(uint32_t lo, uint32_t hi, int s) {
    return __funnelshift_r(lo, hi, s);
}
__device__ __forceinline__ uint64_t funnel_right(uint64_t lo, uint64_t hi, int s) {
    return (lo >> s) | ((hi << 1) << (63 - s));
}

// Row r of a lane whose W-bit rows lie in the words s[0..W): bits
// [r*W, r*W + W) of the lane's bit stream, which end in s[k] or s[k + 1].
// s[k + 1] is read whether the row reaches it or not (the mask cuts what it
// does not): a word past the lane's W, or the pitch's pad, is read but never
// used, so no row branches.
template <typename T>
__device__ __forceinline__ T row_bits(const T* s, int r, int width, T mask) {
    constexpr int TBITS = sizeof(T) * 8;
    const int bit = r * width;
    const int k = bit / TBITS;
    return T(funnel_right(s[k], s[k + 1], bit % TBITS) & mask);
}

__device__ __forceinline__ void store16(uint32_t* p, const uint32_t (&v)[4]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(uint64_t* p, const uint64_t (&v)[2]) {
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0], v[1]);
}

// One word from global to shared memory without a register: cp.async of
// sizeof(T) bytes (4 or 8), completed by cp_async_wait_all.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(sizeof(T)) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One FastLanes block of decode_orig_kernel: thread (lane, j) of the block
// whose words lie lane-major at `words`, its lane's base `carry`, its
// output `o` (the block's first value).
template <typename T, int OP>
__device__ __forceinline__ void decode_orig_block(const T* __restrict__ words, T* __restrict__ o,
                                                  T carry, int width, T mask) {
    using L = OrigOut<T>;
    const int lane = threadIdx.x / L::TPL;
    const int j = threadIdx.x % L::TPL;
    const T* s = words + lane * L::PITCH;
    T v[L::NS][L::VEC];
#pragma unroll
    for (int n = 0; n < L::NS; ++n) {
#pragma unroll
        for (int i = 0; i < L::VEC; ++i) {
            T x = width > 0 ? row_bits(s, L::row(n, j, i), width, mask) : T(0);
            if (OP == OP_UNZDELTA) x = Lanes<T>::unzigzag(x);
            v[n][i] = x;
        }
    }
    if (OP == OP_UNDELTA || OP == OP_UNZDELTA) {
#pragma unroll
        for (int n = 0; n < L::NS; ++n) {
            T part = T(0);
#pragma unroll
            for (int i = 0; i < L::VEC; ++i) part += v[n][i];
            T incl = part;
#pragma unroll
            for (int d = 1; d < L::TPL; d *= 2) {
                const T up = __shfl_up_sync(0xffffffffu, incl, d, L::TPL);
                if (j >= d) incl += up;
            }
            T run = T(carry + (incl - part));
#pragma unroll
            for (int i = 0; i < L::VEC; ++i) {
                run += v[n][i];
                v[n][i] = run;
            }
            carry += __shfl_sync(0xffffffffu, incl, L::TPL - 1, L::TPL);
        }
    }
    o += Orig<T>::seg(lane) * L::TBITS;
#pragma unroll
    for (int n = 0; n < L::NS; ++n) store16(o + L::row(n, j, 0), v[n]);
}

// Original-order decode of u32 and u64 (replaces _kernel_pD :164, _kernel_pE
// :171 and _kernel_pG :267 of benchmarks/exp_untranspose_pallas.py, and the
// zigzag hook of pallas_codecs.py:841). Bytes bound it: a block moves 128*W
// packed and 128*T output bytes (and LANES*T/8 of base) for a few integer
// operations a value. A CUDA block of 256 threads decodes NB blocks (u64 2,
// u32 4) out of 16.9 KB (u32: 17.4 KB) of shared memory with 32 registers a
// thread, so an SM holds 8 CUDA blocks (64 warps) at every W.
//  1. Every thread puts its packed words of all NB blocks (at most 4 a block)
//     and, for the delta ops, one base word in flight at once with cp.async
//     before it waits on any: word LANES*k + lane of block fb goes to
//     words[fb][lane*PITCH + k]. A warp's copies read 32 contiguous words
//     and, the pitch being odd, take the fewest wavefronts that many bytes
//     need. No global load is left after the one barrier.
//  2. Output-stationary: thread (lane, j) computes its ROWS rows of each
//     block straight from the words (row_bits: two shared loads, a funnel
//     shift, a mask; no branch), so no thread walks a lane's T rows in a
//     chain and no value is staged. At most four distinct words meet in one
//     bank (pair) in a warp's row loads: u64 two up to W = 33, u32 one at
//     W = 1 and W = 32.
//  3. Undelta / unzdelta: the running sum of the lane is a scan over its TPL
//     threads (__shfl_up_sync within TPL), one per store run, the run's total
//     carried into the next and the base into the first.
//  4. Each store run of a lane is contiguous in original order (seg(lane)),
//     so a warp's 16-byte stores cover whole 128-byte lines.
// The ragged last CUDA block copies and decodes its live blocks only; every
// thread reaches the one barrier.
template <typename T, int OP>
__global__ void __launch_bounds__(OrigOut<T>::THREADS, OrigOut<T>::MIN_CTAS)
decode_orig_kernel(const T* __restrict__ packed, T* __restrict__ out,
                   const T* __restrict__ base, long long base_stride,
                   long long n_blocks, int width) {
    using L = OrigOut<T>;
    static_assert(L::TPL * L::LANES == L::THREADS && L::NS * L::VEC == L::ROWS, "shape");
    static_assert(L::NB * L::LANES <= L::THREADS, "one base word a thread");
    __shared__ T words[L::NB][L::LANES * L::PITCH];
    __shared__ T bases[L::NB][L::LANES];

    const long long b0 = (long long)blockIdx.x * L::NB;
    const int live = (int)(n_blocks - b0 < L::NB ? n_blocks - b0 : L::NB);
    const int n_words = L::LANES * width;
    if (OP != OP_UNPACK && threadIdx.x < L::NB * L::LANES) {
        const int fb = threadIdx.x / L::LANES;
        const int lane = threadIdx.x % L::LANES;
        if (fb < live) cp_async(&bases[fb][lane], base + (b0 + fb) * base_stride + lane);
    }
#pragma unroll
    for (int fb = 0; fb < L::NB; ++fb) {
        const T* src = packed + (b0 + fb) * n_words;
#pragma unroll
        for (int c = 0; c < L::COPIES; ++c) {
            const int g = threadIdx.x + c * L::THREADS;
            if (fb < live && g < n_words)
                cp_async(&words[fb][(g % L::LANES) * L::PITCH + g / L::LANES], src + g);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    const T mask = width == L::TBITS ? T(~T(0)) : T((T(1) << width) - T(1));
    const int lane = threadIdx.x / L::TPL;
    for (int fb = 0; fb < live; ++fb) {
        const T carry = OP == OP_UNPACK ? T(0) : bases[fb][lane];
        decode_orig_block<T, OP>(words[fb], out + (b0 + fb) * 1024, carry, width, mask);
    }
}

// The loads of the encode row loop: row r of the thread's PER lanes.
template <typename T>
struct LoadTransposed {  // values + b*1024 + PER*q: one row = 128 contiguous bytes a warp
    using V = typename Lanes<T>::V;
    const V* v;
    __device__ __forceinline__ V operator()(int r) const { return v[row_offset(r) / Lanes<T>::PER]; }
};

template <typename T>
struct LoadStaged {  // the lane's segment in shared memory (PER = 1)
    const T* s;
    __device__ __forceinline__ T operator()(int r) const { return s[r]; }
};

// Encode: the mirror of the decode row loop (reference macros.rs:35-98). The
// thread reads its lanes' T rows, applies the hook in a register (ENC_DELTA:
// d = v - prev with prev the UNMASKED previous value, seeded from the base;
// ENC_ZDELTA: the same d, then zigzag (d << 1) ^ (d >> (T-1)) with the shift
// arithmetic on the signed view; ENC_FOR: v - reference, wrapping), masks to
// W bits, or's the row into the word in flight and stores the word at each
// word boundary, keeping the bits that did not fit as the start of the next
// word. A thread writes exactly W words (stride THREADS from o, in units of
// V), so every word of the (uninitialised) output is written once.
template <typename T, int OP, typename Load>
__device__ __forceinline__ void encode_rows(const Load& load, typename Lanes<T>::V* __restrict__ o,
                                            int width, typename Lanes<T>::V prev,
                                            typename Lanes<T>::V reference) {
    using L = Lanes<T>;
    using V = typename L::V;
    constexpr int TBITS = L::TBITS;
    const bool copy = width == TBITS;  // W == T: rows are the words
    const V mask = L::low_bits(width);
    V tmp = V(0);   // the packed word under construction
    int word = 0;   // its index
    int shift = 0;  // bit position of the next row inside it, < TBITS

#pragma unroll
    for (int r = 0; r < TBITS; ++r) {
        V src = load(r);
        if (OP == ENC_DELTA || OP == ENC_ZDELTA) {
            V d = L::sub(src, prev);
            prev = src;
            if (OP == ENC_ZDELTA) d = L::zigzag(d);
            src = d;
        } else if (OP == ENC_FOR) {
            src = L::sub(src, reference);
        }
        if (copy) {
            o[(long long)r * L::THREADS] = src;
            continue;
        }
        src = V(src & mask);
        tmp = V(tmp | L::shift_in(src, shift));
        const int end = shift + width;
        if (end >= TBITS) {
            o[(long long)word * L::THREADS] = tmp;
            ++word;
            // the bits of this row that did not fit open the next word; with
            // remaining == 0 that is none (src is masked)
            const int remaining = end - TBITS;
            tmp = L::carry(src, width, remaining);
            shift = remaining;
        } else {
            shift = end;
        }
    }
}

// Encode with PER lanes a thread, THREADS threads a FastLanes block: every
// op in transposed order, and for u8/u16 the original-order ops (ENC_DELTA,
// ENC_ZDELTA), whose rows come in through load_original. In transposed order
// `base` holds the seeds of ENC_DELTA; in original order it is an OUTPUT:
// row 0 of each transposed block (the FLT delta-chunk base), against which
// the deltas are taken, so delta row 0 is zero. With width == 0 only the
// base is written. The thread reads its rows (transposed order) and its base
// as 32-bit words (or T for u32/u64) and writes its packed words and base
// words likewise, so all must be 4-byte aligned; the original-order loads of
// u16 take 16 bytes, so there the values must be 16-byte aligned.
template <typename T, int OP, int ORDER>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ values, T* __restrict__ out,
              T* __restrict__ base, long long base_stride,
              const T* __restrict__ ref, long long ref_stride, T reference,
              long long n_blocks, int width) {
    using L = Lanes<T>;
    using V = typename L::V;

    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long b = gid / L::THREADS;
    const int q = (int)(gid % L::THREADS);
    if (b >= n_blocks) return;  // ragged last CUDA block: whole warps leave

    V* o = reinterpret_cast<V*>(out) + b * ((long long)L::THREADS * width) + q;
    if constexpr (ORDER == ORDER_TRANSPOSED) {
        V prev = V(0);
        if (OP == ENC_DELTA)
            prev = reinterpret_cast<const V*>(base)[b * (base_stride / L::PER) + q];
        V rf = V(0);
        if (OP == ENC_FOR) rf = L::rep(reference_of(ref, ref_stride, reference, b));
        const LoadTransposed<T> load{reinterpret_cast<const V*>(values) + b * (1024 / L::PER) + q};
        encode_rows<T, OP>(load, o, width, prev, rf);
    } else {
        static_assert(L::PER > 1, "u32/u64 encode from original order in encode_orig_kernel");
        Rows<T> rows;
        load_original(values + b * 1024, q, rows.rows);
        reinterpret_cast<V*>(base)[b * L::THREADS + q] = rows.rows[0];
        if (width == 0) return;
        encode_rows<T, OP>(rows, o, width, rows.rows[0], V(0));
    }
}

// Original-order encode of u32/u64 (OP = ENC_DELTA or ENC_ZDELTA) through
// shared memory: the NB blocks' contiguous values are loaded into the stage
// by consecutive threads; after the barrier each (block, lane) thread reads
// its T rows from its segment, writes row 0 to base_out[b*LANES + lane] and
// packs the deltas against it, as encode_kernel does in original order.
template <typename T, int OP>
__global__ void __launch_bounds__(Orig<T>::THREADS)
encode_orig_kernel(const T* __restrict__ values, T* __restrict__ out,
                   T* __restrict__ base_out, long long n_blocks, int width) {
    using L = Orig<T>;
    static_assert(Lanes<T>::PER == 1, "u8/u16 encode from original order in encode_kernel");
    __shared__ T stage[L::NB * L::BLOCK_PITCH];

    const long long b0 = (long long)blockIdx.x * L::NB;
    const int live = (int)(n_blocks - b0 < L::NB ? n_blocks - b0 : L::NB);
    const T* in = values + b0 * 1024;
    const int n_values = live * 1024;
    for (int i = threadIdx.x; i < n_values; i += L::THREADS) {
        stage[L::staged(i / 1024, i % 1024)] = in[i];
    }
    __syncthreads();

    const int fb = threadIdx.x / L::LANES;
    const int lane = threadIdx.x % L::LANES;
    if (fb >= live) return;  // ragged last CUDA block, after the barrier
    const long long b = b0 + fb;
    const T* s = stage + fb * L::BLOCK_PITCH + L::seg(lane) * L::SEG_PITCH;
    const T first = s[0];
    base_out[b * L::LANES + lane] = first;
    if (width == 0) return;
    encode_rows<T, OP>(LoadStaged<T>{s}, out + b * ((long long)L::LANES * width) + lane,
                       width, first, T(0));
}

// One launch, as the C entries describe it.
struct Job {
    const void* src;
    void* out;
    void* base;
    long long base_stride;
    const void* ref;
    long long ref_stride;
    unsigned long long reference;
    long long n_blocks;
    int width;
    cudaStream_t stream;
};

// CUDA blocks for n_blocks FastLanes blocks of `threads_per_block` threads
// each, `threads_per_cta` to a CUDA block; 0 = refuse.
unsigned grid_of(long long n_blocks, int threads_per_block, int threads_per_cta) {
    const long long grid = (n_blocks * threads_per_block + threads_per_cta - 1) / threads_per_cta;
    return grid <= 0 || grid > 0x7fffffffLL ? 0u : (unsigned)grid;
}

// One launch of (direction, op, order) for dtype T: u8/u16 take both orders
// in decode_kernel / encode_kernel, u32/u64 original order in
// decode_orig_kernel and encode_orig_kernel.
template <bool ENCODE, int OP, int ORDER>
struct Launch {
    template <typename T>
    static int run(const Job& j) {
        using L = Orig<T>;
        constexpr bool wide_orig = ORDER == ORDER_ORIG && Lanes<T>::PER == 1;
        const unsigned grid =
            wide_orig && ENCODE ? grid_of(j.n_blocks, L::LANES, L::THREADS)
            : wide_orig         ? grid_of(j.n_blocks, 1, OrigOut<T>::NB)
                                : grid_of(j.n_blocks, Lanes<T>::THREADS, kThreads);
        if (grid == 0) return (int)cudaErrorInvalidConfiguration;
        const T* src = (const T*)j.src;
        T* out = (T*)j.out;
        T* base = (T*)j.base;
        if constexpr (wide_orig && ENCODE) {
            encode_orig_kernel<T, OP><<<grid, L::THREADS, 0, j.stream>>>(
                src, out, base, j.n_blocks, j.width);
        } else if constexpr (wide_orig) {
            decode_orig_kernel<T, OP><<<grid, OrigOut<T>::THREADS, 0, j.stream>>>(
                src, out, base, j.base_stride, j.n_blocks, j.width);
        } else if constexpr (ENCODE) {
            encode_kernel<T, OP, ORDER><<<grid, kThreads, 0, j.stream>>>(
                src, out, base, j.base_stride, (const T*)j.ref, j.ref_stride, (T)j.reference,
                j.n_blocks, j.width);
        } else {
            decode_kernel<T, OP, ORDER><<<grid, kThreads, 0, j.stream>>>(
                src, out, base, j.base_stride, (const T*)j.ref, j.ref_stride, (T)j.reference,
                j.n_blocks, j.width);
        }
        return (int)cudaGetLastError();
    }
};
template <int OP, int ORDER>
using Decode = Launch<false, OP, ORDER>;
template <int OP, int ORDER>
using Encode = Launch<true, OP, ORDER>;

template <typename Run>
int by_dtype(int tbits, const Job& j) {
    switch (tbits) {
        case 8:  return Run::template run<uint8_t>(j);
        case 16: return Run::template run<uint16_t>(j);
        case 32: return Run::template run<uint32_t>(j);
        case 64: return Run::template run<uint64_t>(j);
    }
    return (int)cudaErrorInvalidValue;
}

// The three decode ops that exist in original order.
template <int ORDER>
int decode_orig_by_op(int op, int tbits, const Job& j) {
    switch (op) {
        case OP_UNPACK:   return by_dtype<Decode<OP_UNPACK, ORDER>>(tbits, j);
        case OP_UNDELTA:  return by_dtype<Decode<OP_UNDELTA, ORDER>>(tbits, j);
        case OP_UNZDELTA: return by_dtype<Decode<OP_UNZDELTA, ORDER>>(tbits, j);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// op: 0 unpack, 1 unfor_pack, 2 undelta_pack, 3 unzdelta_pack.
// order: 0 = the output is in transposed order; 1 = in original order (ops 0,
// 2 and 3 only).
// tbits: 8, 16, 32 or 64. packed: (n_blocks, 1024*width/tbits) words.
// out: (n_blocks, 1024) words. base: per-lane seeds for ops 2 and 3, read at
// base[b*base_stride + lane] (base_stride 0 = shared, LANES = per block).
// ref: for op 1, the reference of block b at ref[b*ref_stride], or null for
// the scalar `reference`, already reduced mod 2^tbits. packed, out and base
// are 4-byte aligned (u8/u16 threads access them as 32-bit words; out 16-byte
// aligned for original order); ref may lie anywhere.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fl_decode(int op, int order, int tbits, const void* packed, void* out,
                         const void* base, long long base_stride, const void* ref,
                         long long ref_stride, unsigned long long reference,
                         long long n_blocks, int width, void* stream) {
    if (width < 0 || width > tbits) return (int)cudaErrorInvalidValue;
    const Job j{packed, out, const_cast<void*>(base), base_stride, ref, ref_stride,
                reference, n_blocks, width, (cudaStream_t)stream};
    switch (order) {
        case ORDER_ORIG: return decode_orig_by_op<ORDER_ORIG>(op, tbits, j);
        case ORDER_TRANSPOSED:
            switch (op) {
                case OP_UNPACK:   return by_dtype<Decode<OP_UNPACK, ORDER_TRANSPOSED>>(tbits, j);
                case OP_UNFOR:    return by_dtype<Decode<OP_UNFOR, ORDER_TRANSPOSED>>(tbits, j);
                case OP_UNDELTA:  return by_dtype<Decode<OP_UNDELTA, ORDER_TRANSPOSED>>(tbits, j);
                case OP_UNZDELTA: return by_dtype<Decode<OP_UNZDELTA, ORDER_TRANSPOSED>>(tbits, j);
            }
    }
    return (int)cudaErrorInvalidValue;
}

// op: 0 pack, 1 delta_pack, 2 for_pack, 3 zigzag delta_pack (order 1 only).
// order 0: values are (n_blocks, 1024) words in transposed order, width in
// [1, tbits]; base holds the per-lane seeds of op 1, read at
// base[b*base_stride + lane] (base_stride 0 = shared, LANES = per block); ref
// and reference are those of fl_decode, for op 2.
// order 1 (ops 1 and 3): values are in original order, width in [0, tbits],
// and base is an OUTPUT of (n_blocks, LANES) words: row 0 of each transposed
// block, against which the deltas are taken. With width 0 only base is
// written and out is not touched.
// out: (n_blocks, 1024*width/tbits) words. values, out and base are 4-byte
// aligned (u8/u16 threads access them as 32-bit words; values 16-byte aligned
// for original order); ref may lie anywhere.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fl_encode(int op, int order, int tbits, const void* values, void* out,
                         void* base, long long base_stride, const void* ref,
                         long long ref_stride, unsigned long long reference,
                         long long n_blocks, int width, void* stream) {
    if (width < (order == ORDER_ORIG ? 0 : 1) || width > tbits)
        return (int)cudaErrorInvalidValue;
    const Job j{values, out, base, base_stride, ref, ref_stride, reference, n_blocks,
                width, (cudaStream_t)stream};
    if (order == ORDER_TRANSPOSED) {
        switch (op) {
            case ENC_PACK:  return by_dtype<Encode<ENC_PACK, ORDER_TRANSPOSED>>(tbits, j);
            case ENC_DELTA: return by_dtype<Encode<ENC_DELTA, ORDER_TRANSPOSED>>(tbits, j);
            case ENC_FOR:   return by_dtype<Encode<ENC_FOR, ORDER_TRANSPOSED>>(tbits, j);
        }
    } else if (order == ORDER_ORIG) {
        switch (op) {
            case ENC_DELTA:  return by_dtype<Encode<ENC_DELTA, ORDER_ORIG>>(tbits, j);
            case ENC_ZDELTA: return by_dtype<Encode<ENC_ZDELTA, ORDER_ORIG>>(tbits, j);
        }
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* fl_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
