// FastLanes codec kernels for NVIDIA Hopper (sm_90a).
//
// Eleven kernels from two row loops. Seven are the CUDA counterparts of the
// kernels that fastlanes_tpu/kernels/pallas_codecs.py builds from
// _unpack_body and _pack_body: unpack, unfor_pack, undelta_pack,
// unzdelta_pack (decode_kernel) and pack, delta_pack, for_pack
// (encode_kernel), all in TRANSPOSED order. Four read or write ORIGINAL
// order in the same pass: unpack_orig, undelta_pack_orig, unzdelta_pack_orig
// (decode_orig_kernel; the in-kernel relayout that
// benchmarks/exp_untranspose_pallas.py tried on the TPU, whose compiler
// refused it) and delta_pack_orig, plain and zigzag (encode_orig_kernel).
//
// Layout facts the design rests on (core/layout.py): packed word w of lane l
// of block b is packed[b*plen + LANES*w + l] with plen = LANES*W, and row r
// of lane l of the transposed-order block is values[b*1024 + row_offset(r) + l]
// with row_offset(r) = (r%8)*128 + FL_ORDER[r/8]*16. In ORIGINAL order the T
// rows of a lane are contiguous: row r of lane l is values[b*1024 + seg(l)*T + r],
// seg a permutation of the lanes (Orig<T>::seg). One thread owns one
// (block, lane): it walks the lane's W words and T rows in registers, so each
// access to a word group and to a transposed row is contiguous across the
// LANES threads of the block (128 bytes for every dtype). The running sum of
// undelta/unzdelta and the previous value of delta_pack are one register per
// thread, seeded from the base; the word under construction in the encode
// loop is another. In the transposed-order kernels nothing is shared between
// threads and nothing is staged. In original order a thread's rows are T
// consecutive values and a warp's row-by-row stores would scatter over 32
// cache lines, so the original-order kernels stage the block in shared
// memory and move it to or from device memory with consecutive threads on
// consecutive words.
//
// These kernels move B*(1024*W/8 + 1024*T/8) bytes (plus B*LANES*T/8 for a
// per-block base) and do a handful of integer operations per value, far
// below the card's compute/bandwidth line: memory traffic bounds them.
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

// Shapes of the original-order kernels. A CUDA block of THREADS threads holds
// NB FastLanes blocks in shared memory, each as LANES segments of T values
// padded by one element (SEG_PITCH = T + 1): with that pitch neither the
// lane-major accesses of the row loop (a warp touches one row of 32 segments)
// nor the row-major accesses of the copy (a warp walks along segments) meet
// in one bank. u64 takes 64 threads so that the stage stays at 33 KB; the
// others take 256 (u8 2.3 KB, u16 8.7 KB, u32 33.8 KB). The copy moves WORDs
// of at least 4 bytes, so a warp moves 128 bytes or more per instruction for
// every dtype.
template <typename T>
struct Orig {
    static constexpr int TBITS = sizeof(T) * 8;
    static constexpr int LANES = 1024 / TBITS;
    static constexpr int THREADS = sizeof(T) == 8 ? 64 : 256;
    static constexpr int NB = THREADS / LANES;
    static constexpr int SEG_PITCH = TBITS + 1;
    static constexpr int BLOCK_PITCH = LANES * SEG_PITCH;
    using Word = typename std::conditional<(sizeof(T) < 4), uint32_t, T>::type;
    static constexpr int PER = sizeof(Word) / sizeof(T);  // values per Word

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

// The stores of the decode row loop: where row r of the thread's lane goes.
template <typename T>
struct StoreTransposed {  // out + b*1024 + lane: one row = 128 contiguous bytes
    T* o;
    __device__ __forceinline__ void operator()(int r, T v) { o[row_offset(r)] = v; }
};

template <typename T>
struct StoreStaged {  // the lane's segment in shared memory
    T* s;
    __device__ __forceinline__ void operator()(int r, T v) { s[r] = v; }
};

// The decode row loop of one (block, lane): p points at the lane's first
// packed word (stride LANES between words); `acc` seeds the running sum of
// the delta ops, `reference` is added by OP_UNFOR.
template <typename T, int OP, typename Store>
__device__ __forceinline__ void decode_rows(const T* __restrict__ p, int width, T acc,
                                            T reference, Store& store) {
    constexpr int TBITS = sizeof(T) * 8;
    constexpr int LANES = 1024 / TBITS;
    const T mask = width == TBITS ? T(~T(0)) : T((T(1) << width) - T(1));
    T src = width > 0 ? p[0] : T(0);
    int word = 0;   // index of the packed word held in src
    int shift = 0;  // bit position of the next row inside src, < TBITS

#pragma unroll
    for (int r = 0; r < TBITS; ++r) {
        T v = T(0);
        if (width > 0) {
            v = T(src >> shift);
            const int end = shift + width;
            if (end >= TBITS) {
                // the row ends at or beyond the word boundary: fetch the next
                // word (none after the last row) and stitch its low bits in
                const int remaining = end - TBITS;
                ++word;
                if (word < width) {
                    src = p[(long long)word * LANES];
                    if (remaining > 0) v = T(v | T(src << (width - remaining)));
                }
                shift = remaining;
            } else {
                shift = end;
            }
            v = T(v & mask);
        }
        if (OP == OP_UNFOR) {
            v = T(v + reference);
        } else if (OP == OP_UNZDELTA) {
            v = T(T(v >> 1) ^ T(T(0) - T(v & T(1))));  // unzigzag
        }
        if (OP == OP_UNDELTA || OP == OP_UNZDELTA) {
            acc = T(acc + v);
            v = acc;
        }
        store(r, v);
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

// Transposed-order decode.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ packed, T* __restrict__ out,
              const T* __restrict__ base, long long base_stride,
              const T* __restrict__ ref, long long ref_stride, T reference,
              long long n_blocks, int width) {
    constexpr int TBITS = sizeof(T) * 8;
    constexpr int LANES = 1024 / TBITS;

    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long b = gid / LANES;
    const int lane = (int)(gid % LANES);
    if (b >= n_blocks) return;  // ragged last CUDA block

    const T* p = packed + b * ((long long)LANES * width) + lane;
    T acc = T(0);
    if (OP == OP_UNDELTA || OP == OP_UNZDELTA) acc = base[b * base_stride + lane];
    T rf = T(0);
    if (OP == OP_UNFOR) rf = reference_of(ref, ref_stride, reference, b);

    StoreTransposed<T> store{out + b * 1024 + lane};
    decode_rows<T, OP>(p, width, acc, rf, store);
}

// Original-order decode through shared memory: the row loop of decode_kernel
// writes each lane's T rows into its segment of the stage; after the barrier
// consecutive threads store consecutive words of the NB blocks' contiguous
// output. No thread leaves before the barrier: those of a ragged last CUDA
// block skip the row loop and the copy stops at the last live block.
template <typename T, int OP>
__global__ void __launch_bounds__(Orig<T>::THREADS)
decode_orig_kernel(const T* __restrict__ packed, T* __restrict__ out,
                   const T* __restrict__ base, long long base_stride,
                   long long n_blocks, int width) {
    using L = Orig<T>;
    using Word = typename L::Word;
    __shared__ T stage[L::NB * L::BLOCK_PITCH];

    const long long b0 = (long long)blockIdx.x * L::NB;
    const int live = (int)(n_blocks - b0 < L::NB ? n_blocks - b0 : L::NB);
    const int fb = threadIdx.x / L::LANES;
    const int lane = threadIdx.x % L::LANES;
    if (fb < live) {
        const long long b = b0 + fb;
        T acc = T(0);
        if (OP == OP_UNDELTA || OP == OP_UNZDELTA) acc = base[b * base_stride + lane];
        StoreStaged<T> store{stage + fb * L::BLOCK_PITCH + L::seg(lane) * L::SEG_PITCH};
        decode_rows<T, OP>(packed + b * ((long long)L::LANES * width) + lane, width, acc,
                           T(0), store);
    }
    __syncthreads();

    Word* o = reinterpret_cast<Word*>(out + b0 * 1024);
    const int n_words = live * (1024 / L::PER);
    for (int i = threadIdx.x; i < n_words; i += L::THREADS) {
        const int e = i * L::PER;
        const T* s = stage + L::staged(e / 1024, e % 1024);
        Word w = s[0];
#pragma unroll
        for (int k = 1; k < L::PER; ++k) w |= Word(s[k]) << (k * L::TBITS);
        o[i] = w;
    }
}

// The loads of the encode row loop: row r of the thread's lane.
template <typename T>
struct LoadTransposed {
    const T* v;
    __device__ __forceinline__ T operator()(int r) const { return v[row_offset(r)]; }
};

template <typename T>
struct LoadStaged {
    const T* s;
    __device__ __forceinline__ T operator()(int r) const { return s[r]; }
};

// Encode: the mirror of the decode row loop (reference macros.rs:35-98). The
// thread reads its lane's T rows, applies the hook in a register (ENC_DELTA:
// d = v - prev with prev the UNMASKED previous value, seeded from the base;
// ENC_ZDELTA: the same d, then zigzag (d << 1) ^ (d >> (T-1)) with the shift
// arithmetic on the signed view; ENC_FOR: v - reference, wrapping), masks to
// W bits, or's the row into the word in flight and stores the word at each
// word boundary, keeping the bits that did not fit as the start of the next
// word. A lane writes exactly W words (stride LANES from o), so every word of
// the (uninitialised) output is written once.
template <typename T, int OP, typename Load>
__device__ __forceinline__ void encode_rows(Load load, T* __restrict__ o, int width,
                                            T prev, T reference) {
    constexpr int TBITS = sizeof(T) * 8;
    constexpr int LANES = 1024 / TBITS;
    const bool copy = width == TBITS;  // W == T: rows are the words
    const T mask = copy ? T(~T(0)) : T((T(1) << width) - T(1));
    T tmp = T(0);   // the packed word under construction
    int word = 0;   // its index
    int shift = 0;  // bit position of the next row inside it, < TBITS

#pragma unroll
    for (int r = 0; r < TBITS; ++r) {
        T src = load(r);
        if (OP == ENC_DELTA || OP == ENC_ZDELTA) {
            T d = T(src - prev);
            prev = src;
            if (OP == ENC_ZDELTA) {
                using S = typename std::make_signed<T>::type;
                d = T(T(d << 1) ^ T(S(d) >> (TBITS - 1)));
            }
            src = d;
        } else if (OP == ENC_FOR) {
            src = T(src - reference);
        }
        if (copy) {
            o[(long long)r * LANES] = src;
            continue;
        }
        src = T(src & mask);
        tmp = T(tmp | T(src << shift));
        const int end = shift + width;
        if (end >= TBITS) {
            o[(long long)word * LANES] = tmp;
            ++word;
            // the bits of this row that did not fit open the next word;
            // width - remaining is in [1, W] and W < T here, so the shift is
            // defined, and with remaining == 0 it leaves 0 (src is masked)
            const int remaining = end - TBITS;
            tmp = T(src >> (width - remaining));
            shift = remaining;
        } else {
            shift = end;
        }
    }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ values, T* __restrict__ out,
              const T* __restrict__ base, long long base_stride,
              const T* __restrict__ ref, long long ref_stride, T reference,
              long long n_blocks, int width) {
    constexpr int TBITS = sizeof(T) * 8;
    constexpr int LANES = 1024 / TBITS;

    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long b = gid / LANES;
    const int lane = (int)(gid % LANES);
    if (b >= n_blocks) return;  // ragged last CUDA block

    T prev = T(0);
    if (OP == ENC_DELTA) prev = base[b * base_stride + lane];
    T rf = T(0);
    if (OP == ENC_FOR) rf = reference_of(ref, ref_stride, reference, b);
    encode_rows<T, OP>(LoadTransposed<T>{values + b * 1024 + lane},
                       out + b * ((long long)LANES * width) + lane, width, prev, rf);
}

// Original-order encode (OP = ENC_DELTA or ENC_ZDELTA): the NB blocks'
// contiguous values are loaded into the stage by consecutive threads; after
// the barrier each (block, lane) thread reads its T rows from its segment,
// writes row 0 to base_out[b*LANES + lane] (the FLT delta-chunk base) and
// packs the deltas against it, so delta row 0 is zero. With width == 0 there
// are no packed words and only the base is written.
template <typename T, int OP>
__global__ void __launch_bounds__(Orig<T>::THREADS)
encode_orig_kernel(const T* __restrict__ values, T* __restrict__ out,
                   T* __restrict__ base_out, long long n_blocks, int width) {
    using L = Orig<T>;
    using Word = typename L::Word;
    __shared__ T stage[L::NB * L::BLOCK_PITCH];

    const long long b0 = (long long)blockIdx.x * L::NB;
    const int live = (int)(n_blocks - b0 < L::NB ? n_blocks - b0 : L::NB);
    const Word* in = reinterpret_cast<const Word*>(values + b0 * 1024);
    const int n_words = live * (1024 / L::PER);
    for (int i = threadIdx.x; i < n_words; i += L::THREADS) {
        const Word w = in[i];
        const int e = i * L::PER;
        T* s = stage + L::staged(e / 1024, e % 1024);
#pragma unroll
        for (int k = 0; k < L::PER; ++k) s[k] = T(w >> (k * L::TBITS));
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

// CUDA blocks for n_blocks FastLanes blocks at `per_cta` each; 0 = refuse.
unsigned grid_of(long long n_blocks, int threads_per_block, int threads_per_cta) {
    const long long grid = (n_blocks * threads_per_block + threads_per_cta - 1) / threads_per_cta;
    return grid <= 0 || grid > 0x7fffffffLL ? 0u : (unsigned)grid;
}

template <int OP, int ORDER>
struct Decode {
    template <typename T>
    static int run(const Job& j) {
        using L = Orig<T>;
        constexpr bool staged = ORDER == ORDER_ORIG;
        const unsigned grid = grid_of(j.n_blocks, L::LANES, staged ? L::THREADS : kThreads);
        if (grid == 0) return (int)cudaErrorInvalidConfiguration;
        if constexpr (staged) {
            decode_orig_kernel<T, OP><<<grid, L::THREADS, 0, j.stream>>>(
                (const T*)j.src, (T*)j.out, (const T*)j.base, j.base_stride, j.n_blocks,
                j.width);
        } else {
            decode_kernel<T, OP><<<grid, kThreads, 0, j.stream>>>(
                (const T*)j.src, (T*)j.out, (const T*)j.base, j.base_stride,
                (const T*)j.ref, j.ref_stride, (T)j.reference, j.n_blocks, j.width);
        }
        return (int)cudaGetLastError();
    }
};

template <int OP, int ORDER>
struct Encode {
    template <typename T>
    static int run(const Job& j) {
        using L = Orig<T>;
        constexpr bool staged = ORDER == ORDER_ORIG;
        const unsigned grid = grid_of(j.n_blocks, L::LANES, staged ? L::THREADS : kThreads);
        if (grid == 0) return (int)cudaErrorInvalidConfiguration;
        if constexpr (staged) {
            encode_orig_kernel<T, OP><<<grid, L::THREADS, 0, j.stream>>>(
                (const T*)j.src, (T*)j.out, (T*)j.base, j.n_blocks, j.width);
        } else {
            encode_kernel<T, OP><<<grid, kThreads, 0, j.stream>>>(
                (const T*)j.src, (T*)j.out, (const T*)j.base, j.base_stride,
                (const T*)j.ref, j.ref_stride, (T)j.reference, j.n_blocks, j.width);
        }
        return (int)cudaGetLastError();
    }
};

template <typename Launch>
int by_dtype(int tbits, const Job& j) {
    switch (tbits) {
        case 8:  return Launch::template run<uint8_t>(j);
        case 16: return Launch::template run<uint16_t>(j);
        case 32: return Launch::template run<uint32_t>(j);
        case 64: return Launch::template run<uint64_t>(j);
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
// the scalar `reference`, already reduced mod 2^tbits.
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
// out: (n_blocks, 1024*width/tbits) words.
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
