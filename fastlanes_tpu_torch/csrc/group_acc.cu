// The GROUP BY accumulator's feed for NVIDIA Hopper (sm_90a): one launch
// adds one lockstep window into the per-group state of
// fastlanes_tpu_torch/analytics.py's _GroupAcc.
//
// It replaces no TPU kernel. The JAX package accumulates groups with plain
// XLA scatters (`.at[].add/min/max` in fastlanes_tpu/analytics.py,
// _GroupAcc); the port's plain version (_GroupAcc.feed_plain) is the same
// scatters in PyTorch: index_add_ for counts and sums, scatter_reduce_
// amin/amax for the extremes, and about 15 elementwise passes that write
// per-row tensors to device memory first. With few groups every row of a
// window lands on a handful of int64 addresses, and the 64-bit atomics
// queue there: q1's key has 3 groups, so ~6 M rows a window met on 256
// addresses (64 spread copies of 4 slots).
//
// What bounds it: the bytes of key, value and mask, read once. A TPC-H Q1
// window is ~6 M rows x (1 key + <= 8 value + 1 mask bytes), ~60-80 MB,
// about 24 us at 3.35 TB/s; the accumulator itself is a few KB to a few MB.
// Per row the arithmetic is a few dozen integer operations.
//
// What the design does about the atomics:
//   1. Each row is turned into its addends in registers (the group g = key +
//      offset, a negative key wrapped to g + k + 1, slot k for a row that
//      fails the range or the mask; the count column, the addend columns
//      and values, the extreme's slot and key) and nothing per row is
//      written to device memory.
//   2. Within a warp, rows that add at the same addresses (the same slot,
//      and for floats the same class or superaccumulator bin) are found
//      with __match_any_sync and summed with a tree of shuffles: one atomic
//      per distinct address a warp, not one a row. A decimal column puts
//      nearly every row of a group into one bin, so a warp of q1 makes a
//      few atomics for 32 rows.
//   3. SHARED mode, where (k + 1) x (n_cols + 2) int64 fit in the dynamic
//      shared memory one block may take: each block keeps a private copy of
//      the whole accumulator in shared memory, and adds it into the device
//      accumulator once at its end, one atomic per nonzero slot and column.
//      The grid is as many blocks as fit on the card at once, each walking
//      the rows with a stride. The device accumulator has a single copy.
//   4. GLOBAL mode otherwise (many groups, where rows spread over many
//      addresses anyway): warps add straight into the device accumulator's
//      spread copies, warp w into copy w % spread.
// Every addend is an integer under 2^32 in magnitude and int64 addition is
// exact in any order, so the state is the plain version's bit for bit.
//
// Plain C interface for ctypes; no PyTorch headers. The entry launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { KIND_INT = 0, KIND_I64 = 1, KIND_F32 = 2, KIND_F64 = 3 };

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;  // a lane past the window's end
constexpr long long kMax = 0x7fffffffffffffffLL;
constexpr long long kMin = -kMax - 1;

// IEEE fields and the superaccumulator of analytics._FLOAT_SPEC
template <int KIND>
struct Float;
template <>
struct Float<KIND_F32> {
    using Bits = int32_t;
    static constexpr Bits LOW = 0x7fffffff;  // every bit but the sign
    static constexpr int E = 8, F = 23, PLANES = 1, BUCKETS = 32;
};
template <>
struct Float<KIND_F64> {
    using Bits = int64_t;
    static constexpr Bits LOW = 0x7fffffffffffffffLL;
    static constexpr int E = 11, F = 52, PLANES = 2, BUCKETS = 256;
};

// int: [count, sum]; i64: [count, low halves, high halves]; floats: [finite,
// NaN, +inf, -inf counts, bins (sign, bucket, plane)]
template <int KIND>
__host__ __device__ constexpr int n_cols() {
    if constexpr (KIND == KIND_INT) return 2;
    else if constexpr (KIND == KIND_I64) return 3;
    else return 4 + 2 * Float<KIND>::BUCKETS * Float<KIND>::PLANES;
}

// What one row adds: 1 to column `count_col` of slot `slot`, a0 (and a1) to
// columns add_col (add_col + 1), and its signed or total-order key to the
// extremes of `ext_slot` (mn = mx = that key). Rows with equal `key` add at
// the same addresses.
struct Row {
    unsigned key;
    long long slot, ext_slot;
    int count_col, add_col;
    long long a0, a1, mn, mx;
};

template <int KIND, typename KT, typename VT>
__device__ __forceinline__ Row row_of(const KT* key, long long key_offset, const VT* value,
                                      const uint8_t* mask, long long i, int k) {
    long long g = (long long)key[i] + key_offset;
    if (g < 0) g += k + 1;  // a negative key indexes from the end
    if (g < 0 || g >= k || (mask != nullptr && !mask[i])) g = k;  // the trash slot
    const VT x = value[i];
    Row r;
    r.slot = g;
    r.ext_slot = g;
    r.key = (unsigned)g;
    r.count_col = 0;
    r.add_col = 1;
    r.a1 = 0;
    if constexpr (KIND == KIND_INT) {
        r.a0 = (long long)x;
        r.mn = r.mx = (long long)x;
    } else if constexpr (KIND == KIND_I64) {
        r.a0 = (long long)x & 0xFFFFFFFFLL;
        r.a1 = (long long)x >> 32;
        r.mn = r.mx = (long long)x;
    } else {
        using S = Float<KIND>;
        using B = typename S::Bits;
        const B bits = (B)x;
        const int sign = (int)((bits >> (S::E + S::F)) & 1);
        const int exp = (int)((bits >> S::F) & ((1 << S::E) - 1));
        const B frac = bits & (((B)1 << S::F) - 1);
        const bool special = exp == (1 << S::E) - 1;
        const bool nan = special && frac != 0;
        const int ep = exp < 1 ? 1 : exp;
        const B m = special ? (B)0 : (B)(frac | ((B)(exp > 0) << S::F));
        const B shifted = (B)(m << (ep & 7));  // < 2^61 (f64), < 2^31 (f32)
        r.count_col = special ? (nan ? 1 : 2 + sign) : 0;
        r.add_col = 4 + (sign * S::BUCKETS + (ep >> 3)) * S::PLANES;
        if constexpr (S::PLANES == 2) {
            r.a0 = (long long)shifted & 0xFFFFFFFFLL;
            r.a1 = (long long)shifted >> 32;
        } else {
            r.a0 = (long long)shifted;
        }
        // the total-order key; a NaN's extremes go to the trash slot
        const B order = bits ^ ((bits >> (8 * sizeof(B) - 1)) & S::LOW);
        r.mn = r.mx = (long long)order;
        if (nan) r.ext_slot = k;
        // a special row adds nothing to a bin: its class alone tells it apart
        // (g <= 1024 for float values, so the key stays below 2^22)
        r.key = (unsigned)(g * 2048 + (special ? r.count_col : r.add_col));
    }
    return r;
}

// The lowest lane of `peers` (the lanes of one key) gets the sums, min and
// max over them: a tree over the peers in lane order, each round every lane
// takes the next peer still in play above it, then the odd-ranked drop out.
template <bool TWO>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane, Row& r) {
    unsigned rest = peers & (0xfffffffeu << lane);            // peers above this lane
    unsigned rank = __popc(peers & ((1u << lane) - 1u));      // its place among them
    while (__any_sync(kFull, rest != 0)) {
        const int next = __ffs(rest) - 1;
        const int src = next < 0 ? lane : next;
        const long long a0 = __shfl_sync(kFull, r.a0, src);
        const long long a1 = TWO ? __shfl_sync(kFull, r.a1, src) : 0;
        const long long mn = __shfl_sync(kFull, r.mn, src);
        const long long mx = __shfl_sync(kFull, r.mx, src);
        if (next >= 0) {
            r.a0 += a0;
            if (TWO) r.a1 += a1;
            r.mn = mn < r.mn ? mn : r.mn;
            r.mx = mx > r.mx ? mx : r.mx;
        }
        rest &= ~__ballot_sync(kFull, rank & 1u);
        rank >>= 1;
    }
}

// One block: SHARED, a private accumulator in shared memory added into
// add/mn/mx at the end; else warp w adds into copy w % spread of them.
template <int KIND, typename KT, typename VT, bool SHARED>
__global__ void __launch_bounds__(kThreads)
group_acc_kernel(const KT* __restrict__ key, long long key_offset, const VT* __restrict__ value,
                 const uint8_t* __restrict__ mask, long long valid, int k,
                 long long* __restrict__ add, long long* __restrict__ mn,
                 long long* __restrict__ mx, int spread) {
    constexpr long long C = n_cols<KIND>();
    constexpr bool TWO = KIND == KIND_I64 || KIND == KIND_F64;
    extern __shared__ long long smem[];
    const long long slots = (long long)k + 1;
    if constexpr (SHARED) {
        for (long long j = threadIdx.x; j < slots * C; j += blockDim.x) smem[j] = 0;
        for (long long j = threadIdx.x; j < slots; j += blockDim.x) {
            smem[slots * C + j] = kMax;
            smem[slots * (C + 1) + j] = kMin;
        }
        __syncthreads();
    }
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * (kThreads / 32);
    for (long long w = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32; w * 32 < valid;
         w += warps) {
        const long long i = w * 32 + lane;
        Row r;
        if (i < valid) {
            r = row_of<KIND>(key, key_offset, value, mask, i, k);
        } else {
            r = Row{kNoKey, 0, 0, 0, 0, 0, 0, 0, 0};
        }
        const unsigned peers = __match_any_sync(kFull, r.key);
        const bool leader = (peers & ((1u << lane) - 1u)) == 0;
        reduce_peers<TWO>(peers, lane, r);
        if (!leader || r.key == kNoKey) continue;
        long long *a, *lo, *hi;
        if constexpr (SHARED) {
            a = smem;
            lo = smem + slots * C;
            hi = lo + slots;
        } else {
            const long long copy = w % spread;
            a = add + copy * slots * C;
            lo = mn + copy * slots;
            hi = mx + copy * slots;
        }
        atomicAdd((unsigned long long*)&a[r.slot * C + r.count_col],
                  (unsigned long long)__popc(peers));
        if (r.a0 != 0)
            atomicAdd((unsigned long long*)&a[r.slot * C + r.add_col], (unsigned long long)r.a0);
        if (TWO && r.a1 != 0)
            atomicAdd((unsigned long long*)&a[r.slot * C + r.add_col + 1],
                      (unsigned long long)r.a1);
        // extremes only move one way: a stale read can only ask for an
        // atomic that was not needed, never skip one that was
        if (r.mn < lo[r.ext_slot]) atomicMin(&lo[r.ext_slot], r.mn);
        if (r.mx > hi[r.ext_slot]) atomicMax(&hi[r.ext_slot], r.mx);
    }
    if constexpr (SHARED) {
        __syncthreads();
        for (long long j = threadIdx.x; j < slots * C; j += blockDim.x) {
            const long long v = smem[j];
            if (v != 0) atomicAdd((unsigned long long*)&add[j], (unsigned long long)v);
        }
        for (long long j = threadIdx.x; j < slots; j += blockDim.x) {
            const long long lo = smem[slots * C + j], hi = smem[slots * (C + 1) + j];
            if (lo != kMax) atomicMin(&mn[j], lo);
            if (hi != kMin) atomicMax(&mx[j], hi);
        }
    }
}

struct Job {
    const void* key;
    long long key_offset;
    const void* value;
    const uint8_t* mask;
    long long valid;
    int k;
    long long *add, *mn, *mx;
    int spread;
    cudaStream_t stream;
};

template <int KIND, typename KT, typename VT, bool SHARED>
int launch(const Job& j) {
    auto kernel = group_acc_kernel<KIND, KT, VT, SHARED>;
    const size_t smem = SHARED ? (size_t)(j.k + 1) * (n_cols<KIND>() + 2) * sizeof(long long) : 0;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long grid = (j.valid + kThreads - 1) / kThreads;
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
    kernel<<<(unsigned)grid, kThreads, smem, j.stream>>>(
        (const KT*)j.key, j.key_offset, (const VT*)j.value, j.mask, j.valid, j.k, j.add, j.mn,
        j.mx, j.spread);
    return (int)cudaGetLastError();
}

template <int KIND, typename KT, typename VT>
int by_mode(int shared, const Job& j) {
    return shared ? launch<KIND, KT, VT, true>(j) : launch<KIND, KT, VT, false>(j);
}

template <typename KT>
int by_value(int kind, int value_bytes, int shared, const Job& j) {
    switch (kind * 16 + value_bytes) {
        case KIND_INT * 16 + 1: return by_mode<KIND_INT, KT, int8_t>(shared, j);
        case KIND_INT * 16 + 2: return by_mode<KIND_INT, KT, int16_t>(shared, j);
        case KIND_INT * 16 + 4: return by_mode<KIND_INT, KT, int32_t>(shared, j);
        case KIND_I64 * 16 + 8: return by_mode<KIND_I64, KT, int64_t>(shared, j);
        case KIND_F32 * 16 + 4: return by_mode<KIND_F32, KT, int32_t>(shared, j);
        case KIND_F64 * 16 + 8: return by_mode<KIND_F64, KT, int64_t>(shared, j);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 int (values of 1, 2 or 4 bytes, signed keys), 1 i64, 2 f32 (IEEE
// bits as int32), 3 f64 (bits as int64). key: `valid` signed integers of
// key_bytes (1, 2, 4); group = key + key_offset. mask: `valid` bytes, 0
// drops the row into the trash slot k, or null. add: spread x (k + 1) x
// n_cols int64, mn / mx: spread x (k + 1) int64, where n_cols is 2, 3, 68
// or 1028 by kind. shared: 1 keeps one private accumulator a block in shared
// memory (spread must be 1 and (k + 1) x (n_cols + 2) x 8 bytes must fit the
// block's dynamic shared memory), 0 adds into the spread copies directly.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fl_group_acc(int kind, int key_bytes, int value_bytes, const void* key,
                            long long key_offset, const void* value, const void* mask,
                            long long valid, int k, void* add, void* mn, void* mx, int spread,
                            int shared, void* stream) {
    if (valid <= 0 || k < 0 || spread < 1 || (shared && spread != 1))
        return (int)cudaErrorInvalidValue;
    const Job j{key, key_offset, value, (const uint8_t*)mask, valid, k, (long long*)add,
                (long long*)mn, (long long*)mx, spread, (cudaStream_t)stream};
    switch (key_bytes) {
        case 1: return by_value<int8_t>(kind, value_bytes, shared, j);
        case 2: return by_value<int16_t>(kind, value_bytes, shared, j);
        case 4: return by_value<int32_t>(kind, value_bytes, shared, j);
    }
    return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block may take on `device` (the card's
// opt-in limit, 232448 bytes on an H100), into *bytes.
extern "C" int fl_group_shared_bytes(int device, int* bytes) {
    return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
