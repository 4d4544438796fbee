// Native batch assembler for the expert-feature input pipeline.
//
// The port's copy of native/assembler.cc (same C ABI, same semantics),
// built by mmt_tpu_torch/_build.py:build_host at first use and bound by
// mmt_tpu_torch/data/native_assembler.py.  It replaces the Python hot
// loop that materializes per-sample padded feature blocks and then
// re-copies them in collate (data/sample.py choose_or_pad_features +
// collate): one C call per (batch, expert) writes gathered/cast/padded
// rows straight into the preallocated batch arrays, with the GIL
// released for the whole call, so the loader's threads assemble in
// parallel.
//
// Numerics contract (bit-exact vs the Python path, pinned by
// tests/test_torch_native_assembler.py):
//  - float64 -> float32 feature casts use IEEE round-to-nearest-even,
//    identical to numpy astype.
//  - temporal encodings compute (t - start) / window + 2 in double
//    (the same op order as data/sample.py) before the final cast.
//  - row picks arrive precomputed from Python so the numpy RNG stream
//    order is unchanged.
//
// Called through ctypes (releases the GIL for the whole batch write).

#include <cstdint>
#include <cstring>

namespace {

inline void copy_cast_row(float* dst, const void* src, int64_t row,
                          int64_t dim, bool src_f64) {
  if (src_f64) {
    const double* s = static_cast<const double*>(src) + row * dim;
    for (int64_t j = 0; j < dim; ++j) dst[j] = static_cast<float>(s[j]);
  } else {
    std::memcpy(dst, static_cast<const float*>(src) + row * dim,
                static_cast<size_t>(dim) * sizeof(float));
  }
}

}  // namespace

extern "C" {

// Slot kinds (one slot per output [T, D] block, i.e. per sample-pair):
//   0 missing    feat=0, t=1, ind=0            (sample.py:_missing_block)
//   1 preformed  memcpy float32 (feat, t, ind) (memoized feat_blocks)
//   2 raw        gather k rows, cast, pad      (choose_or_pad_features)
// flags bit 0: raw feature source is float64; bit 1: pick indices given
// (else the first k rows are taken).
void mmt_asm_features(float* dst_feat, float* dst_t, float* dst_ind,
                      int64_t n_slots, int64_t T, int64_t D,
                      const int32_t* kind, const int32_t* k,
                      const int32_t* flags,
                      const uint64_t* feat_src, const uint64_t* t_src,
                      const uint64_t* ind_src, const uint64_t* pick,
                      const double* t_start, const double* t_window) {
  for (int64_t s = 0; s < n_slots; ++s) {
    float* df = dst_feat + s * T * D;
    float* dt = dst_t + s * T;
    float* di = dst_ind + s * T;
    switch (kind[s]) {
      case 0: {
        std::memset(df, 0, static_cast<size_t>(T) * D * sizeof(float));
        for (int64_t i = 0; i < T; ++i) dt[i] = 1.0f;
        std::memset(di, 0, static_cast<size_t>(T) * sizeof(float));
        break;
      }
      case 1: {
        std::memcpy(df, reinterpret_cast<const void*>(feat_src[s]),
                    static_cast<size_t>(T) * D * sizeof(float));
        std::memcpy(dt, reinterpret_cast<const void*>(t_src[s]),
                    static_cast<size_t>(T) * sizeof(float));
        std::memcpy(di, reinterpret_cast<const void*>(ind_src[s]),
                    static_cast<size_t>(T) * sizeof(float));
        break;
      }
      default: {
        const int64_t kk = k[s];
        const bool f64 = flags[s] & 1;
        const int64_t* pk =
            (flags[s] & 2) ? reinterpret_cast<const int64_t*>(pick[s])
                           : nullptr;
        const void* src = reinterpret_cast<const void*>(feat_src[s]);
        const double* st = reinterpret_cast<const double*>(t_src[s]);
        const double t0 = t_start[s], tw = t_window[s];
        for (int64_t i = 0; i < kk; ++i) {
          const int64_t row = pk ? pk[i] : i;
          copy_cast_row(df + i * D, src, row, D, f64);
          dt[i] = static_cast<float>((st[row] - t0) / tw + 2.0);
          di[i] = 1.0f;
        }
        if (kk < T) {
          std::memset(df + kk * D, 0,
                      static_cast<size_t>(T - kk) * D * sizeof(float));
          for (int64_t i = kk; i < T; ++i) dt[i] = 1.0f;
          std::memset(di + kk, 0,
                      static_cast<size_t>(T - kk) * sizeof(float));
        }
        break;
      }
    }
  }
}

// Pooled (avg/max) rows: kind 0 -> zero row (missing modality,
// sample.py:_zero_row); kind 2 -> copy/cast one row of width D.
void mmt_asm_rows(float* dst, int64_t n, int64_t D, const int32_t* kind,
                  const int32_t* src_f64, const uint64_t* src) {
  for (int64_t s = 0; s < n; ++s) {
    float* d = dst + s * D;
    if (kind[s] == 0) {
      std::memset(d, 0, static_cast<size_t>(D) * sizeof(float));
    } else {
      copy_cast_row(d, reinterpret_cast<const void*>(src[s]), 0, D,
                    src_f64[s] != 0);
    }
  }
}

}  // extern "C"
