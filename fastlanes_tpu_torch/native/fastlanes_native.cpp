// fastlanes_native.cpp — C++ host codec of fastlanes_tpu_torch.
//
// The port's own copy of the JAX package's host codec
// (fastlanes_tpu/native/fastlanes_native.cpp): the same code, so the same
// bytes. Role: the host half of the stack. Host writers and readers of the
// FLT format (fio.py) encode and decode through it while the GPU runs the
// CUDA kernels; it is also an implementation of the codec independent of the
// NumPy oracle.
//
// Written from the FastLanes layout spec (Afroozeh & Boncz, VLDB 2023) with
// the transposed-order iteration of the Rust reference crate
// (spiraldb/fastlanes: src/macros.rs pack!/unpack!, src/bitpacking.rs,
// src/delta.rs, src/ffor.rs, src/transpose.rs) — wire-compatible with that
// crate, NOT with the original C++ FastLanes (see reference README.md:51-52).
//
// Design: unlike the reference's lane-outer/row-inner macro unrolling, loops
// here are row-outer/lane-inner. Each transposed row is a contiguous slice
// of the block (index(row,lane) = row_offset(row) + lane), so the inner lane
// loop reads/writes contiguous memory with loop-invariant shifts — exactly
// what LLVM/GCC auto-vectorize to SIMD with no intrinsics.
//
// Build (native/__init__.py): g++ -O2 -fvect-cost-model=dynamic
// -march=native -shared -fPIC, as
// FL_PARTS parts compiled in parallel. Part p (-DFL_PARTS=P -DFL_PART=p)
// instantiates the unrolled bodies of the widths W with W % P == p only; its
// dispatch tables hold nullptr for the other widths, so a caller passes width
// W to part W % P. Every part carries the whole C interface, and the entries
// without a width template (delta, transpose, unpack_single) work in any.
// Without FL_PARTS the file builds the whole library in one unit, slowly:
// the 65 unrolled u64 widths dominate.

#include <array>
#include <cstdint>
#include <cstring>
#include <utility>

#if defined(__AVX512F__) || defined(__AVX2__) || defined(__SSE2__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Non-temporal row stores. Streaming decode is WRITE-bandwidth-bound on the
// host (the output is T/W times larger than the input); regular stores pay
// read-for-ownership, fetching every output cache line before overwriting
// it. Every transposed row is exactly 128 bytes (NL * sizeof(T) == 128 for
// all four dtypes) and row offsets are 128-byte multiples, so rows can be
// streamed as two (AVX-512) / four (AVX2) full non-temporal cache lines
// when the destination block is 64-byte aligned.

constexpr bool kHaveNT =
#if defined(__AVX512F__) || defined(__AVX2__) || defined(__SSE2__)
    true;
#else
    false;
#endif

inline void nt_store_row128(void* dst, const void* src) {
#if defined(__AVX512F__)
  _mm512_stream_si512(reinterpret_cast<__m512i*>(dst),
                      _mm512_load_si512(src));
  _mm512_stream_si512(reinterpret_cast<__m512i*>(static_cast<char*>(dst) + 64),
                      _mm512_load_si512(static_cast<const char*>(src) + 64));
#elif defined(__AVX2__)
  for (int i = 0; i < 4; ++i)
    _mm256_stream_si256(
        reinterpret_cast<__m256i*>(static_cast<char*>(dst) + 32 * i),
        _mm256_load_si256(reinterpret_cast<const __m256i*>(
            static_cast<const char*>(src) + 32 * i)));
#elif defined(__SSE2__)
  for (int i = 0; i < 8; ++i)
    _mm_stream_si128(
        reinterpret_cast<__m128i*>(static_cast<char*>(dst) + 16 * i),
        _mm_load_si128(reinterpret_cast<const __m128i*>(
            static_cast<const char*>(src) + 16 * i)));
#else
  std::memcpy(dst, src, 128);
#endif
}

inline void nt_fence() {
#if defined(__AVX512F__) || defined(__AVX2__) || defined(__SSE2__)
  _mm_sfence();
#endif
}

constexpr int kFLOrder[8] = {0, 4, 2, 6, 1, 5, 3, 7};
constexpr int kBlock = 1024;

constexpr int row_offset(int row) {
  return (row & 7) * 128 + kFLOrder[row >> 3] * 16;
}

template <typename T>
struct FL {
  static constexpr int TB = int(sizeof(T)) * 8;      // bit width
  static constexpr int NL = kBlock / TB;             // lanes
};

// mask(width) per reference macros.rs:141-143
template <typename T>
constexpr T mask_of(int width) {
  constexpr int TB = FL<T>::TB;
  return width >= TB ? T(~T(0)) : T((T(1) << (width % TB)) - 1);
}

// ---------------------------------------------------------------------------
// pack: reference macros.rs:35-98 semantics, vectorized lane-inner.
// src_of(row) must return a pointer to the LANES contiguous values of the
// transposed row (for plain pack: in + row_offset(row)).

// One compile-time row of the pack pipeline: every shift/mask/word index is
// a constant (the C++ twin of the reference's seq_t! unrolling, lib.rs:41-47
// / macros.rs:67-69 — what makes the compiler emit straight-line SIMD).
template <typename T, int W, int ROW, typename RowFn>
inline void pack_row_step(RowFn& src_of, T* __restrict out, T* __restrict tmp) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  constexpr T mask = T((T(1) << W) - 1);
  constexpr int shift = (ROW * W) % TB;
  constexpr int curr_word = (ROW * W) / TB;
  constexpr int next_word = ((ROW + 1) * W) / TB;
  const T* src = src_of(ROW);
  if constexpr (ROW == 0) {
    for (int lane = 0; lane < NL; ++lane) tmp[lane] = T(src[lane] & mask);
  } else {
    for (int lane = 0; lane < NL; ++lane)
      tmp[lane] = T(tmp[lane] | T(T(src[lane] & mask) << shift));
  }
  if constexpr (next_word > curr_word) {
    T* dst = out + size_t(NL) * curr_word;
    for (int lane = 0; lane < NL; ++lane) dst[lane] = tmp[lane];
    constexpr int rem = ((ROW + 1) * W) % TB;
    // carry bits that did not fit (W - rem <= W < TB)
    for (int lane = 0; lane < NL; ++lane)
      tmp[lane] = T(T(src[lane] & mask) >> (W - rem));
  }
}

template <typename T, int W, typename RowFn, size_t... R>
inline void pack_rows_unrolled(RowFn& src_of, T* __restrict out,
                               std::index_sequence<R...>) {
  constexpr int NL = FL<T>::NL;
  T tmp[NL];
  (pack_row_step<T, W, int(R)>(src_of, out, tmp), ...);
}

template <typename T, int W, typename RowFn>
inline void pack_rows(RowFn src_of, T* __restrict out) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  if constexpr (W == 0) {
    return;
  } else if constexpr (W == TB) {
    for (int row = 0; row < TB; ++row) {
      const T* src = src_of(row);
      T* dst = out + size_t(NL) * row;
      for (int lane = 0; lane < NL; ++lane) dst[lane] = src[lane];
    }
  } else {
    pack_rows_unrolled<T, W>(src_of, out, std::make_index_sequence<TB>{});
  }
}

// ---------------------------------------------------------------------------
// unpack: reference macros.rs:101-174 semantics; sink(row, elems[NL]) gets
// each transposed row — the kernel-body hook enabling fused delta/FoR.

// One compile-time row of the unpack pipeline (constant words/shifts/masks;
// reference macros.rs:142-170 via seq_t!-style unrolling).
template <typename T, int W, int ROW, typename Sink>
inline void unpack_row_step(const T* __restrict in, T* __restrict elems,
                            Sink& sink) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  constexpr int curr_word = (ROW * W) / TB;
  constexpr int next_word = ((ROW + 1) * W) / TB;
  constexpr int shift = (ROW * W) % TB;
  const T* src = in + size_t(NL) * curr_word;
  if constexpr (next_word > curr_word) {
    constexpr int rem = ((ROW + 1) * W) % TB;
    constexpr T m_cur = mask_of<T>(W - rem);
    for (int lane = 0; lane < NL; ++lane)
      elems[lane] = T(T(src[lane] >> shift) & m_cur);
    if constexpr (next_word < W) {
      const T* src2 = in + size_t(NL) * next_word;
      constexpr T m_rem = mask_of<T>(rem);
      for (int lane = 0; lane < NL; ++lane)
        elems[lane] = T(elems[lane] | T(T(src2[lane] & m_rem) << (W - rem)));
    }
  } else {
    constexpr T m = mask_of<T>(W);
    for (int lane = 0; lane < NL; ++lane)
      elems[lane] = T(T(src[lane] >> shift) & m);
  }
  sink(ROW, elems);
}

template <typename T, int W, typename Sink, size_t... R>
inline void unpack_rows_unrolled(const T* __restrict in, Sink& sink,
                                 std::index_sequence<R...>) {
  constexpr int NL = FL<T>::NL;
  alignas(64) T elems[NL];
  (unpack_row_step<T, W, int(R)>(in, elems, sink), ...);
}

// Plain decode specialization: each row is computed straight into its
// (compile-time) destination slice — no elems bounce, no sink indirection.
struct NoSink {
  template <typename T>
  void operator()(int, const T*) const {}
};

template <typename T, int W, size_t... R>
inline void unpack_rows_direct(const T* __restrict in, T* __restrict out,
                               std::index_sequence<R...>) {
  NoSink nosink;
  (unpack_row_step<T, W, int(R)>(in, out + row_offset(int(R)), nosink), ...);
}

template <typename T, int W, typename Sink>
inline void unpack_rows(const T* __restrict in, Sink sink) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  alignas(64) T elems[NL];
  if constexpr (W == 0) {
    for (int lane = 0; lane < NL; ++lane) elems[lane] = 0;
    for (int row = 0; row < TB; ++row) sink(row, elems);
  } else if constexpr (W == TB) {
    for (int row = 0; row < TB; ++row) {
      const T* src = in + size_t(NL) * row;
      for (int lane = 0; lane < NL; ++lane) elems[lane] = src[lane];
      sink(row, elems);
    }
  } else {
    unpack_rows_unrolled<T, W>(in, sink, std::make_index_sequence<TB>{});
  }
}

// ---------------------------------------------------------------------------
// per-block codec entry points

template <typename T, int W>
void pack_block(const T* in, T* out) {
  pack_rows<T, W>([in](int row) { return in + row_offset(row); }, out);
}

template <typename T, int W>
void unpack_block(const T* in, T* out) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  if constexpr (W != 0 && W != TB) {
    unpack_rows_direct<T, W>(in, out, std::make_index_sequence<TB>{});
  } else {
    unpack_rows<T, W>(in, [out](int row, const T* elems) {
      T* dst = out + row_offset(row);
      for (int lane = 0; lane < NL; ++lane) dst[lane] = elems[lane];
    });
  }
}

// Non-temporal decode twins: rows are computed in a 64B-aligned stack
// buffer, then streamed to the destination as full cache lines (no RFO).
// Used by the batched drivers when the output is 64B-aligned and large
// enough that it cannot be cache-resident anyway (see kNTMinBlocks).

template <typename T, int W>
void unpack_block_nt(const T* in, T* out) {
  unpack_rows<T, W>(in, [out](int row, const T* elems) {
    nt_store_row128(out + row_offset(row), elems);
  });
}

// FoR: reference ffor.rs:24-50
template <typename T, int W>
void for_pack_block(const T* in, T reference, T* out) {
  constexpr int NL = FL<T>::NL;
  T row_buf[NL];
  pack_rows<T, W>(
      [&](int row) {
        const T* src = in + row_offset(row);
        for (int lane = 0; lane < NL; ++lane) row_buf[lane] = T(src[lane] - reference);
        return static_cast<const T*>(row_buf);
      },
      out);
}

template <typename T, int W>
void unfor_pack_block(const T* in, T reference, T* out) {
  constexpr int NL = FL<T>::NL;
  unpack_rows<T, W>(in, [out, reference](int row, const T* elems) {
    T* dst = out + row_offset(row);
    for (int lane = 0; lane < NL; ++lane) dst[lane] = T(elems[lane] + reference);
  });
}

template <typename T, int W>
void unfor_pack_block_nt(const T* in, T reference, T* out) {
  constexpr int NL = FL<T>::NL;
  alignas(64) T row[NL];
  unpack_rows<T, W>(in, [&](int r, const T* elems) {
    for (int lane = 0; lane < NL; ++lane) row[lane] = T(elems[lane] + reference);
    nt_store_row128(out + row_offset(r), row);
  });
}

// Delta: reference delta.rs:24-63 (base = per-lane seeds)
template <typename T>
void delta_block(const T* in, const T* base, T* out) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  T prev[NL];
  for (int lane = 0; lane < NL; ++lane) prev[lane] = base[lane];
  for (int row = 0; row < TB; ++row) {
    const T* src = in + row_offset(row);
    T* dst = out + row_offset(row);
    for (int lane = 0; lane < NL; ++lane) {
      dst[lane] = T(src[lane] - prev[lane]);
      prev[lane] = src[lane];
    }
  }
}

template <typename T>
void undelta_block(const T* in, const T* base, T* out) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  T prev[NL];
  for (int lane = 0; lane < NL; ++lane) prev[lane] = base[lane];
  for (int row = 0; row < TB; ++row) {
    const T* src = in + row_offset(row);
    T* dst = out + row_offset(row);
    for (int lane = 0; lane < NL; ++lane) {
      prev[lane] = T(src[lane] + prev[lane]);
      dst[lane] = prev[lane];
    }
  }
}

// Fused undelta+unpack: reference delta.rs:48-63
template <typename T, int W>
void undelta_pack_block(const T* in, const T* base, T* out) {
  constexpr int NL = FL<T>::NL;
  T prev[NL];
  for (int lane = 0; lane < NL; ++lane) prev[lane] = base[lane];
  unpack_rows<T, W>(in, [out, &prev](int row, const T* elems) {
    T* dst = out + row_offset(row);
    for (int lane = 0; lane < NL; ++lane) {
      prev[lane] = T(elems[lane] + prev[lane]);
      dst[lane] = prev[lane];
    }
  });
}

template <typename T, int W>
void undelta_pack_block_nt(const T* in, const T* base, T* out) {
  constexpr int NL = FL<T>::NL;
  alignas(64) T prev[NL];
  for (int lane = 0; lane < NL; ++lane) prev[lane] = base[lane];
  unpack_rows<T, W>(in, [&](int r, const T* elems) {
    for (int lane = 0; lane < NL; ++lane) prev[lane] = T(elems[lane] + prev[lane]);
    nt_store_row128(out + row_offset(r), prev);
  });
}

// Fused delta+pack (composition the reference leaves to callers)
template <typename T, int W>
void delta_pack_block(const T* in, const T* base, T* out) {
  constexpr int NL = FL<T>::NL;
  T prev[NL], row_buf[NL];
  for (int lane = 0; lane < NL; ++lane) prev[lane] = base[lane];
  pack_rows<T, W>(
      [&](int row) {
        const T* src = in + row_offset(row);
        for (int lane = 0; lane < NL; ++lane) {
          row_buf[lane] = T(src[lane] - prev[lane]);
          prev[lane] = src[lane];
        }
        return static_cast<const T*>(row_buf);
      },
      out);
}

// Transpose: reference transpose.rs:11-36
template <typename T>
void transpose_block(const T* in, T* out) {
  for (int i = 0; i < kBlock; ++i) {
    const int lane = i % 16, order = (i / 16) % 8, row = i / 128;
    out[i] = in[lane * 64 + kFLOrder[order] * 8 + row];
  }
}

template <typename T>
void untranspose_block(const T* in, T* out) {
  for (int i = 0; i < kBlock; ++i) {
    const int lane = i % 16, order = (i / 16) % 8, row = i / 128;
    out[lane * 64 + kFLOrder[order] * 8 + row] = in[i];
  }
}

// unpack_single: reference bitpacking.rs:131-179
template <typename T>
T unpack_single_block(const T* packed, int width, int index) {
  constexpr int TB = FL<T>::TB, NL = FL<T>::NL;
  if (width == 0) return T(0);
  const int lane = index % NL;
  const int s = index / 128;
  const int fl_order = (index - s * 128 - lane) / 16;
  const int row = kFLOrder[fl_order] * 8 + s;  // FL_ORDER self-inverse
  if (width == TB) return packed[size_t(NL) * row + lane];
  const T mask = mask_of<T>(width);
  const int start_bit = row * width;
  const int start_word = start_bit / TB;
  const int lo_shift = start_bit % TB;
  const int remaining = TB - lo_shift;
  const T lo = T(packed[size_t(NL) * start_word + lane] >> lo_shift);
  if (remaining >= width) return T(lo & mask);
  const T hi = T(packed[size_t(NL) * (start_word + 1) + lane] << remaining);
  return T(T(lo | hi) & mask);
}

// ---------------------------------------------------------------------------
// runtime width dispatch tables (the seq_t! match of bitpacking.rs:115-128)

template <typename T>
using PackFn = void (*)(const T*, T*);
template <typename T>
using ScalarFn = void (*)(const T*, T, T*);
template <typename T>
using BaseFn = void (*)(const T*, const T*, T*);

// Whether width W belongs to this part of a parallel build (see Build).
template <int W>
constexpr bool in_part() {
#if defined(FL_PARTS)
  return W % FL_PARTS == FL_PART;
#else
  return true;
#endif
}

// A dispatch-table entry: the (T, W) body in its own part, else nullptr (the
// discarded branch instantiates nothing).
#define FL_TABLE_ENTRY(NAME, FN, SIG)      \
  template <typename T, int W>             \
  constexpr SIG<T> NAME() {                \
    if constexpr (in_part<W>())            \
      return &FN<T, W>;                    \
    else                                   \
      return nullptr;                      \
  }

FL_TABLE_ENTRY(pack_entry, pack_block, PackFn)
FL_TABLE_ENTRY(unpack_entry, unpack_block, PackFn)
FL_TABLE_ENTRY(forpack_entry, for_pack_block, ScalarFn)
FL_TABLE_ENTRY(unforpack_entry, unfor_pack_block, ScalarFn)
FL_TABLE_ENTRY(undelta_pack_entry, undelta_pack_block, BaseFn)
FL_TABLE_ENTRY(delta_pack_entry, delta_pack_block, BaseFn)

template <typename T, size_t... Ws>
constexpr auto make_pack_table(std::index_sequence<Ws...>) {
  return std::array<PackFn<T>, sizeof...(Ws)>{pack_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_unpack_table(std::index_sequence<Ws...>) {
  return std::array<PackFn<T>, sizeof...(Ws)>{unpack_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_forpack_table(std::index_sequence<Ws...>) {
  return std::array<ScalarFn<T>, sizeof...(Ws)>{forpack_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_unforpack_table(std::index_sequence<Ws...>) {
  return std::array<ScalarFn<T>, sizeof...(Ws)>{unforpack_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_undelta_pack_table(std::index_sequence<Ws...>) {
  return std::array<BaseFn<T>, sizeof...(Ws)>{undelta_pack_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_delta_pack_table(std::index_sequence<Ws...>) {
  return std::array<BaseFn<T>, sizeof...(Ws)>{delta_pack_entry<T, int(Ws)>()...};
}

template <typename T>
struct Tables {
  static constexpr auto seq = std::make_index_sequence<FL<T>::TB + 1>{};
  static inline const auto pack = make_pack_table<T>(seq);
  static inline const auto unpack = make_unpack_table<T>(seq);
  static inline const auto for_pack = make_forpack_table<T>(seq);
  static inline const auto unfor_pack = make_unforpack_table<T>(seq);
  static inline const auto undelta_pack = make_undelta_pack_table<T>(seq);
  static inline const auto delta_pack = make_delta_pack_table<T>(seq);
};

template <typename T>
size_t packed_elems(int width) {
  return size_t(kBlock) * width / FL<T>::TB;
}

// generic batched drivers ----------------------------------------------------
// The pack/unpack BATCH LOOP is monomorphized per (T, W) — the reference's
// unchecked_* width-match pattern (bitpacking.rs:115-128) — so the block
// body inlines into the loop (a per-block indirect call measured ~1.7x
// slower on u32 W=3 decode: the dispatch cost is not the call itself but
// the lost inlining/unrolled scheduling across the loop).

template <typename T, int W>
void pack_loop(const T* __restrict src, T* __restrict dst, long n_blocks) {
  constexpr size_t pe = size_t(kBlock) * W / FL<T>::TB;
  for (long b = 0; b < n_blocks; ++b)
    pack_block<T, W>(src + b * kBlock, dst + b * pe);
}

template <typename T, int W>
void unpack_loop(const T* __restrict src, T* __restrict dst, long n_blocks) {
  constexpr size_t pe = size_t(kBlock) * W / FL<T>::TB;
  for (long b = 0; b < n_blocks; ++b)
    unpack_block<T, W>(src + b * pe, dst + b * kBlock);
}

template <typename T, int W>
void unpack_loop_nt(const T* __restrict src, T* __restrict dst, long n_blocks) {
  constexpr size_t pe = size_t(kBlock) * W / FL<T>::TB;
  for (long b = 0; b < n_blocks; ++b)
    unpack_block_nt<T, W>(src + b * pe, dst + b * kBlock);
  nt_fence();
}

// NT pays off only when the output is too big to live in cache (streaming
// decode); below this it would evict data a consumer is about to reuse.
// 512 blocks = 2 MiB of u32 output.
constexpr long kNTMinBlocks = 512;

template <typename T>
inline bool use_nt(const void* dst, long n_blocks) {
  return kHaveNT && n_blocks >= kNTMinBlocks &&
         (reinterpret_cast<uintptr_t>(dst) & 63) == 0;
}

template <typename T>
using LoopFn = void (*)(const T*, T*, long);

FL_TABLE_ENTRY(pack_loop_entry, pack_loop, LoopFn)
FL_TABLE_ENTRY(unpack_loop_entry, unpack_loop, LoopFn)
FL_TABLE_ENTRY(unpack_nt_loop_entry, unpack_loop_nt, LoopFn)
FL_TABLE_ENTRY(unforpack_nt_entry, unfor_pack_block_nt, ScalarFn)
FL_TABLE_ENTRY(undelta_pack_nt_entry, undelta_pack_block_nt, BaseFn)

template <typename T, size_t... Ws>
constexpr auto make_pack_loop_table(std::index_sequence<Ws...>) {
  return std::array<LoopFn<T>, sizeof...(Ws)>{pack_loop_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_unpack_loop_table(std::index_sequence<Ws...>) {
  return std::array<LoopFn<T>, sizeof...(Ws)>{unpack_loop_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_unpack_nt_loop_table(std::index_sequence<Ws...>) {
  return std::array<LoopFn<T>, sizeof...(Ws)>{unpack_nt_loop_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_unforpack_nt_table(std::index_sequence<Ws...>) {
  return std::array<ScalarFn<T>, sizeof...(Ws)>{unforpack_nt_entry<T, int(Ws)>()...};
}
template <typename T, size_t... Ws>
constexpr auto make_undelta_pack_nt_table(std::index_sequence<Ws...>) {
  return std::array<BaseFn<T>, sizeof...(Ws)>{undelta_pack_nt_entry<T, int(Ws)>()...};
}

template <typename T>
struct LoopTables {
  static constexpr auto seq = std::make_index_sequence<FL<T>::TB + 1>{};
  static inline const auto pack = make_pack_loop_table<T>(seq);
  static inline const auto unpack = make_unpack_loop_table<T>(seq);
  static inline const auto unpack_nt = make_unpack_nt_loop_table<T>(seq);
  static inline const auto unfor_pack_nt = make_unforpack_nt_table<T>(seq);
  static inline const auto undelta_pack_nt = make_undelta_pack_nt_table<T>(seq);
};

template <typename T>
int run_pack(int width, const void* in, void* out, long n_blocks, bool unpack_dir) {
  if (width < 0 || width > FL<T>::TB) return -1;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (unpack_dir) {
    if (use_nt<T>(dst, n_blocks))
      LoopTables<T>::unpack_nt[width](src, dst, n_blocks);
    else
      LoopTables<T>::unpack[width](src, dst, n_blocks);
  } else {
    LoopTables<T>::pack[width](src, dst, n_blocks);
  }
  return 0;
}

template <typename T>
int run_for(int width, const void* in, unsigned long long reference, void* out,
            long n_blocks, bool unpack_dir) {
  if (width < 0 || width > FL<T>::TB) return -1;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const T ref = T(reference);
  const size_t pe = packed_elems<T>(width);
  const bool nt = unpack_dir && use_nt<T>(dst, n_blocks);
  for (long b = 0; b < n_blocks; ++b) {
    if (nt)
      LoopTables<T>::unfor_pack_nt[width](src + b * pe, ref, dst + b * kBlock);
    else if (unpack_dir)
      Tables<T>::unfor_pack[width](src + b * pe, ref, dst + b * kBlock);
    else
      Tables<T>::for_pack[width](src + b * kBlock, ref, dst + b * pe);
  }
  if (nt) nt_fence();
  return 0;
}

template <typename T>
int run_delta_fused(int width, const void* in, const void* base, void* out,
                    long n_blocks, bool unpack_dir) {
  if (width < 0 || width > FL<T>::TB) return -1;
  const T* src = static_cast<const T*>(in);
  const T* bs = static_cast<const T*>(base);
  T* dst = static_cast<T*>(out);
  const size_t pe = packed_elems<T>(width);
  constexpr int NL = FL<T>::NL;
  const bool nt = unpack_dir && use_nt<T>(dst, n_blocks);
  for (long b = 0; b < n_blocks; ++b) {
    if (nt)
      LoopTables<T>::undelta_pack_nt[width](src + b * pe, bs + b * NL,
                                            dst + b * kBlock);
    else if (unpack_dir)
      Tables<T>::undelta_pack[width](src + b * pe, bs + b * NL, dst + b * kBlock);
    else
      Tables<T>::delta_pack[width](src + b * kBlock, bs + b * NL, dst + b * pe);
  }
  if (nt) nt_fence();
  return 0;
}

template <typename T>
int run_delta(const void* in, const void* base, void* out, long n_blocks, bool undo) {
  const T* src = static_cast<const T*>(in);
  const T* bs = static_cast<const T*>(base);
  T* dst = static_cast<T*>(out);
  constexpr int NL = FL<T>::NL;
  for (long b = 0; b < n_blocks; ++b) {
    if (undo)
      undelta_block<T>(src + b * kBlock, bs + b * NL, dst + b * kBlock);
    else
      delta_block<T>(src + b * kBlock, bs + b * NL, dst + b * kBlock);
  }
  return 0;
}

template <typename T>
int run_transpose(const void* in, void* out, long n_blocks, bool undo) {
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  for (long b = 0; b < n_blocks; ++b) {
    if (undo)
      untranspose_block<T>(src + b * kBlock, dst + b * kBlock);
    else
      transpose_block<T>(src + b * kBlock, dst + b * kBlock);
  }
  return 0;
}

template <typename T>
int run_unpack_single(int width, const void* in, const long* indices, long n_idx,
                      void* out, long n_blocks) {
  if (width < 0 || width > FL<T>::TB) return -1;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const size_t pe = packed_elems<T>(width);
  for (long b = 0; b < n_blocks; ++b)
    for (long k = 0; k < n_idx; ++k)
      dst[b * n_idx + k] =
          unpack_single_block<T>(src + b * pe, width, int(indices[k]));
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI: dtype_code 0=u8 1=u16 2=u32 3=u64; dir 0=encode 1=decode.

#define DISPATCH_DTYPE(FN, ...)                      \
  switch (dtype_code) {                              \
    case 0: return FN<uint8_t>(__VA_ARGS__);         \
    case 1: return FN<uint16_t>(__VA_ARGS__);        \
    case 2: return FN<uint32_t>(__VA_ARGS__);        \
    case 3: return FN<uint64_t>(__VA_ARGS__);        \
    default: return -2;                              \
  }

extern "C" {

int fl_pack(int dtype_code, int width, const void* in, void* out, long n_blocks) {
  DISPATCH_DTYPE(run_pack, width, in, out, n_blocks, false)
}
int fl_unpack(int dtype_code, int width, const void* in, void* out, long n_blocks) {
  DISPATCH_DTYPE(run_pack, width, in, out, n_blocks, true)
}
int fl_for_pack(int dtype_code, int width, const void* in, unsigned long long reference,
                void* out, long n_blocks) {
  DISPATCH_DTYPE(run_for, width, in, reference, out, n_blocks, false)
}
int fl_unfor_pack(int dtype_code, int width, const void* in, unsigned long long reference,
                  void* out, long n_blocks) {
  DISPATCH_DTYPE(run_for, width, in, reference, out, n_blocks, true)
}
int fl_delta(int dtype_code, const void* in, const void* base, void* out, long n_blocks) {
  DISPATCH_DTYPE(run_delta, in, base, out, n_blocks, false)
}
int fl_undelta(int dtype_code, const void* in, const void* base, void* out, long n_blocks) {
  DISPATCH_DTYPE(run_delta, in, base, out, n_blocks, true)
}
int fl_delta_pack(int dtype_code, int width, const void* in, const void* base, void* out,
                  long n_blocks) {
  DISPATCH_DTYPE(run_delta_fused, width, in, base, out, n_blocks, false)
}
int fl_undelta_pack(int dtype_code, int width, const void* in, const void* base, void* out,
                    long n_blocks) {
  DISPATCH_DTYPE(run_delta_fused, width, in, base, out, n_blocks, true)
}
int fl_transpose(int dtype_code, const void* in, void* out, long n_blocks) {
  DISPATCH_DTYPE(run_transpose, in, out, n_blocks, false)
}
int fl_untranspose(int dtype_code, const void* in, void* out, long n_blocks) {
  DISPATCH_DTYPE(run_transpose, in, out, n_blocks, true)
}
int fl_unpack_single(int dtype_code, int width, const void* in, const long* indices,
                     long n_idx, void* out, long n_blocks) {
  DISPATCH_DTYPE(run_unpack_single, width, in, indices, n_idx, out, n_blocks)
}

}  // extern "C"
