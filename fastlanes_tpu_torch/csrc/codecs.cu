// FastLanes codec kernels for NVIDIA Hopper (sm_90a).
//
// Seven kernels from two bodies, the CUDA counterparts of the seven kernels
// that fastlanes_tpu/kernels/pallas_codecs.py builds from _unpack_body and
// _pack_body: unpack, unfor_pack, undelta_pack, unzdelta_pack (decode_kernel)
// and pack, delta_pack, for_pack (encode_kernel).
//
// Layout facts the design rests on (core/layout.py): packed word w of lane l
// of block b is packed[b*plen + LANES*w + l] with plen = LANES*W, and row r
// of lane l of the transposed-order block is values[b*1024 + row_offset(r) + l]
// with row_offset(r) = (r%8)*128 + FL_ORDER[r/8]*16. One thread owns one
// (block, lane): it walks the lane's W words and T rows in registers, so each
// access to a word group and to a row is contiguous across the LANES threads
// of the block (128 bytes for every dtype). The running sum of
// undelta/unzdelta and the previous value of delta_pack are one register per
// thread, seeded from the base; the word under construction in the encode
// kernel is another. Nothing is shared or carried between threads or CUDA
// blocks, and nothing is staged.
//
// These kernels move B*(1024*W/8 + 1024*T/8) bytes (plus B*LANES*T/8 for a
// per-block base) and do a handful of integer operations per value, far
// below the card's compute/bandwidth line: memory traffic bounds them.
//
// The bit width W is a run-time argument (one instantiation per dtype and
// op, 28 in all). A shift by T is undefined in C++, so the W-bit mask, the
// W == T copy and the word-boundary stitch are guarded, and every shift of a
// uint8_t/uint16_t (which promotes to int) is truncated with T(...). Decode
// handles every W in [0, T]; encode every W in [1, T] (W == 0 has no output
// words, so there is nothing to launch).
//
// Plain C interface for ctypes; no PyTorch headers. The entries launch on the
// stream they are given, allocate nothing, do not synchronise, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { OP_UNPACK = 0, OP_UNFOR = 1, OP_UNDELTA = 2, OP_UNZDELTA = 3 };
enum EncodeOp { ENC_PACK = 0, ENC_DELTA = 1, ENC_FOR = 2 };

constexpr int kThreads = 256;

// FL_ORDER = (0, 4, 2, 6, 1, 5, 3, 7) is the 3-bit reversal of its index.
__host__ __device__ constexpr int fl_order(int o) {
    return ((o & 1) << 2) | (o & 2) | ((o >> 2) & 1);
}

__host__ __device__ constexpr int row_offset(int r) {
    return (r % 8) * 128 + fl_order(r / 8) * 16;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ packed, T* __restrict__ out,
              const T* __restrict__ base, T reference, long long n_blocks,
              int width, long long base_stride) {
    constexpr int TBITS = sizeof(T) * 8;
    constexpr int LANES = 1024 / TBITS;

    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long b = gid / LANES;
    const int lane = (int)(gid % LANES);
    if (b >= n_blocks) return;  // ragged last CUDA block

    const T* p = packed + b * ((long long)LANES * width) + lane;
    T* o = out + b * 1024 + lane;

    T acc = T(0);
    if (OP == OP_UNDELTA || OP == OP_UNZDELTA) acc = base[b * base_stride + lane];

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
        o[row_offset(r)] = v;
    }
}

// Encode: the mirror of decode_kernel (reference macros.rs:35-98). The thread
// reads its lane's T rows, applies the hook in a register (ENC_DELTA:
// d = v - prev with prev the UNMASKED previous value, seeded from the base;
// ENC_FOR: v - reference, wrapping), masks to W bits, or's the row into the
// word in flight and stores the word at each word boundary, keeping the bits
// that did not fit as the start of the next word. A lane writes exactly W
// words, so every word of the (uninitialised) output is written once.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ values, T* __restrict__ out,
              const T* __restrict__ base, T reference, long long n_blocks,
              int width, long long base_stride) {
    constexpr int TBITS = sizeof(T) * 8;
    constexpr int LANES = 1024 / TBITS;

    const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long b = gid / LANES;
    const int lane = (int)(gid % LANES);
    if (b >= n_blocks) return;  // ragged last CUDA block

    const T* v = values + b * 1024 + lane;
    T* o = out + b * ((long long)LANES * width) + lane;

    T prev = T(0);
    if (OP == ENC_DELTA) prev = base[b * base_stride + lane];

    const bool copy = width == TBITS;  // W == T: rows are the words
    const T mask = copy ? T(~T(0)) : T((T(1) << width) - T(1));
    T tmp = T(0);   // the packed word under construction
    int word = 0;   // its index
    int shift = 0;  // bit position of the next row inside it, < TBITS

#pragma unroll
    for (int r = 0; r < TBITS; ++r) {
        T src = v[row_offset(r)];
        if (OP == ENC_DELTA) {
            const T d = T(src - prev);
            prev = src;
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
int launch_encode(const void* values, void* out, const void* base,
                  unsigned long long reference, long long n_blocks, int width,
                  long long base_stride, cudaStream_t stream) {
    constexpr int LANES = 1024 / (int)(sizeof(T) * 8);
    const long long threads = n_blocks * LANES;
    const long long grid = (threads + kThreads - 1) / kThreads;
    if (grid <= 0 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    encode_kernel<T, OP><<<(unsigned)grid, kThreads, 0, stream>>>(
        (const T*)values, (T*)out, (const T*)base, (T)reference, n_blocks,
        width, base_stride);
    return (int)cudaGetLastError();
}

template <int OP>
int launch_encode_dtype(int tbits, const void* values, void* out, const void* base,
                        unsigned long long reference, long long n_blocks, int width,
                        long long base_stride, cudaStream_t stream) {
    switch (tbits) {
        case 8:  return launch_encode<uint8_t, OP>(values, out, base, reference, n_blocks, width, base_stride, stream);
        case 16: return launch_encode<uint16_t, OP>(values, out, base, reference, n_blocks, width, base_stride, stream);
        case 32: return launch_encode<uint32_t, OP>(values, out, base, reference, n_blocks, width, base_stride, stream);
        case 64: return launch_encode<uint64_t, OP>(values, out, base, reference, n_blocks, width, base_stride, stream);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, int OP>
int launch(const void* packed, void* out, const void* base,
           unsigned long long reference, long long n_blocks, int width,
           long long base_stride, cudaStream_t stream) {
    constexpr int LANES = 1024 / (int)(sizeof(T) * 8);
    const long long threads = n_blocks * LANES;
    const long long grid = (threads + kThreads - 1) / kThreads;
    if (grid <= 0 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    decode_kernel<T, OP><<<(unsigned)grid, kThreads, 0, stream>>>(
        (const T*)packed, (T*)out, (const T*)base, (T)reference, n_blocks,
        width, base_stride);
    return (int)cudaGetLastError();
}

template <int OP>
int launch_dtype(int tbits, const void* packed, void* out, const void* base,
                 unsigned long long reference, long long n_blocks, int width,
                 long long base_stride, cudaStream_t stream) {
    switch (tbits) {
        case 8:  return launch<uint8_t, OP>(packed, out, base, reference, n_blocks, width, base_stride, stream);
        case 16: return launch<uint16_t, OP>(packed, out, base, reference, n_blocks, width, base_stride, stream);
        case 32: return launch<uint32_t, OP>(packed, out, base, reference, n_blocks, width, base_stride, stream);
        case 64: return launch<uint64_t, OP>(packed, out, base, reference, n_blocks, width, base_stride, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// op: 0 unpack, 1 unfor_pack, 2 undelta_pack, 3 unzdelta_pack.
// tbits: 8, 16, 32 or 64. packed: (n_blocks, 1024*width/tbits) words.
// out: (n_blocks, 1024) words. base: per-lane seeds for ops 2 and 3, read at
// base[b*base_stride + lane] (base_stride 0 = shared, LANES = per block).
// reference: the scalar for op 1, already reduced mod 2^tbits.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fl_decode(int op, int tbits, const void* packed, void* out,
                         const void* base, unsigned long long reference,
                         long long n_blocks, int width, long long base_stride,
                         void* stream) {
    if (width < 0 || width > tbits) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case OP_UNPACK:   return launch_dtype<OP_UNPACK>(tbits, packed, out, base, reference, n_blocks, width, base_stride, s);
        case OP_UNFOR:    return launch_dtype<OP_UNFOR>(tbits, packed, out, base, reference, n_blocks, width, base_stride, s);
        case OP_UNDELTA:  return launch_dtype<OP_UNDELTA>(tbits, packed, out, base, reference, n_blocks, width, base_stride, s);
        case OP_UNZDELTA: return launch_dtype<OP_UNZDELTA>(tbits, packed, out, base, reference, n_blocks, width, base_stride, s);
    }
    return (int)cudaErrorInvalidValue;
}

// op: 0 pack, 1 delta_pack, 2 for_pack.
// tbits: 8, 16, 32 or 64. values: (n_blocks, 1024) words in transposed order.
// out: (n_blocks, 1024*width/tbits) words, width in [1, tbits]. base: per-lane
// seeds for op 1, read at base[b*base_stride + lane] (base_stride 0 = shared,
// LANES = per block). reference: the scalar for op 2, reduced mod 2^tbits.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fl_encode(int op, int tbits, const void* values, void* out,
                         const void* base, unsigned long long reference,
                         long long n_blocks, int width, long long base_stride,
                         void* stream) {
    if (width < 1 || width > tbits) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case ENC_PACK:  return launch_encode_dtype<ENC_PACK>(tbits, values, out, base, reference, n_blocks, width, base_stride, s);
        case ENC_DELTA: return launch_encode_dtype<ENC_DELTA>(tbits, values, out, base, reference, n_blocks, width, base_stride, s);
        case ENC_FOR:   return launch_encode_dtype<ENC_FOR>(tbits, values, out, base, reference, n_blocks, width, base_stride, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* fl_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
