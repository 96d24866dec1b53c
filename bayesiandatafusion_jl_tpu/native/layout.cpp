// Native data-layer: degree-bucketed layout builder + sparse binary I/O.
//
// The device compute path is JAX/XLA; this is the host-side runtime
// tier (the reference's "data loading layer" — IndexedDF construction and
// .sbm feature-file parsing, SURVEY.md §5.2/§6-IO).  For Netflix-scale inputs
// (1e8+ observations) the one-pass C++ builder keeps preprocessing off the
// critical path; Python falls back to the vectorized NumPy builder when
// this library isn't compiled.
//
// Build: make -C bayesiandatafusion_jl_tpu/native   (produces libbdf_native.so)
// ABI: plain C, driven via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Phase 1: piece planning.
// Splits each instance's observation run into chunks (head-instance skew
// handling): floor(deg/wmax) full chunks of wmax + a remainder chunk
// assigned to the smallest bucket width that fits.
// Outputs per-bucket piece counts so the caller can allocate.
// Returns total pieces, or -1 on error.
// ---------------------------------------------------------------------------
int64_t bdf_plan_layout(
    int64_t nnz, int32_t n_modes, int32_t mode, int64_t n_instances,
    const int32_t* idx,            // [nnz, n_modes] row-major
    const int64_t* widths, int32_t n_widths,
    int64_t* deg_out,              // [n_instances] scratch+output
    int64_t* pieces_per_width_out  // [n_widths]
) {
    if (n_widths <= 0) return -1;
    const int64_t wmax = widths[n_widths - 1];
    memset(deg_out, 0, sizeof(int64_t) * n_instances);
    for (int64_t n = 0; n < nnz; ++n) {
        int32_t i = idx[n * n_modes + mode];
        if (i < 0 || i >= n_instances) return -1;
        deg_out[i]++;
    }
    memset(pieces_per_width_out, 0, sizeof(int64_t) * n_widths);
    int64_t total = 0;
    for (int64_t i = 0; i < n_instances; ++i) {
        int64_t d = deg_out[i];
        if (d == 0) continue;
        int64_t full = d / wmax, rem = d - full * wmax;
        pieces_per_width_out[n_widths - 1] += full;
        if (rem > 0) {
            int32_t c = 0;
            while (widths[c] < rem) ++c;
            pieces_per_width_out[c]++;
        }
        total += full + (rem > 0);
    }
    return total;
}

// ---------------------------------------------------------------------------
// Phase 2: fill caller-allocated bucket arrays in one pass.
// Caller passes, per bucket: row capacity (padded), and pointers
//   inst[rows], part[(n_modes-1)][rows*W], val[rows*W], mask[rows*W]
// packed as arrays-of-pointers.  Values are float32, centered by `mean`.
// Observations are processed in CSR-by-instance order (stable).
// Returns 0 on success.
// ---------------------------------------------------------------------------
int32_t bdf_fill_layout(
    int64_t nnz, int32_t n_modes, int32_t mode, int64_t n_instances,
    const int32_t* idx, const double* vals, double mean,
    const int64_t* widths, int32_t n_widths,
    const int64_t* deg,            // from bdf_plan_layout
    int32_t** inst_ptrs,           // [n_widths] -> int32[rows_w]
    int32_t** part_ptrs,           // [n_widths*(n_modes-1)] -> int32[rows_w*W]
    float** val_ptrs,              // [n_widths] -> float[rows_w*W]
    float** mask_ptrs              // [n_widths] -> float[rows_w*W]
) {
    const int64_t wmax = widths[n_widths - 1];
    // CSR pointers by instance
    std::vector<int64_t> ptr(n_instances + 1, 0);
    for (int64_t i = 0; i < n_instances; ++i) ptr[i + 1] = ptr[i] + deg[i];
    // stable counting sort of observation ids by instance
    std::vector<int64_t> order(nnz);
    {
        std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
        for (int64_t n = 0; n < nnz; ++n) {
            int32_t i = idx[n * n_modes + mode];
            order[cur[i]++] = n;
        }
    }
    std::vector<int64_t> next_row(n_widths, 0);  // next free row per bucket

    const int32_t n_other = n_modes - 1;
    for (int64_t i = 0; i < n_instances; ++i) {
        int64_t off = ptr[i], remaining = deg[i];
        while (remaining > 0) {
            int64_t len = remaining > wmax ? wmax : remaining;
            int32_t c = n_widths - 1;
            if (remaining <= wmax) {
                c = 0;
                while (widths[c] < len) ++c;
            }
            const int64_t W = widths[c];
            const int64_t r = next_row[c]++;
            inst_ptrs[c][r] = (int32_t)i;
            float* vrow = val_ptrs[c] + r * W;
            float* mrow = mask_ptrs[c] + r * W;
            for (int64_t w = 0; w < len; ++w) {
                const int64_t obs = order[off + w];
                vrow[w] = (float)(vals[obs] - mean);
                mrow[w] = 1.0f;
                int32_t k = 0;
                for (int32_t d = 0; d < n_modes; ++d) {
                    if (d == mode) continue;
                    part_ptrs[c * n_other + k][r * W + w] =
                        idx[obs * n_modes + d];
                    ++k;
                }
            }
            off += len;
            remaining -= len;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Sparse binary I/O (SBM1 format, matches ops/sparse.py).
// ---------------------------------------------------------------------------
int64_t bdf_read_sbm_header(const char* path, int64_t* shape_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char magic[4];
    int64_t hdr[3];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "SBM1", 4) != 0 ||
        fread(hdr, 8, 3, f) != 3) {
        fclose(f);
        return -1;
    }
    shape_out[0] = hdr[0];
    shape_out[1] = hdr[1];
    fclose(f);
    return hdr[2];  // nnz
}

int32_t bdf_read_sbm(const char* path, int64_t nnz,
                     int32_t* rows, int32_t* cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 4 + 24, SEEK_SET);
    size_t ok = fread(rows, 4, nnz, f);
    ok += fread(cols, 4, nnz, f);
    fclose(f);
    return ok == (size_t)(2 * nnz) ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Dense-pair accumulation for the dense Gramian path (ops/dense_gram.py):
// M[lin] += 1, W[lin] += centered[n] over flat f32 [total] arrays, with an
// optional mode permutation applied per element.  One tight loop replaces
// np.add.at's generic-ufunc inner loop (~35 s -> ~1 s at ML-10M).  The
// accumulation order and f32 cast-then-add match the NumPy fallback
// bitwise (observation order, per-addend f64->f32 cast).
// ---------------------------------------------------------------------------
int32_t bdf_accum_dense_pair(
    int64_t nnz,
    const int64_t* lin,       // [nnz] flat indices, SORTED ascending (the
                              // caller stable-sorts: per-cell addend order
                              // is then identical to observation order, so
                              // results are bitwise equal to an unsorted
                              // scatter, while the writes walk the GB-scale
                              // arrays sequentially — the unsorted walk
                              // page-faults/TLB-misses its way to ~30 s at
                              // ML-10M vs ~0.2 s sorted)
    const double* centered,   // [nnz] in the same sorted order
    int64_t total, float* M, float* W) {
    for (int64_t n = 0; n < nnz; ++n) {
        const int64_t i = lin[n];
        if (i < 0 || i >= total) return -1;
        M[i] += 1.0f;
        W[i] += (float)centered[n];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// int8 quantization of an accumulated pair (quantize_dense_pair): returns
// w_scale = max|W|/127 (1.0 when W == 0) and fills M8 = (int8)M,
// W8 = clip(rint(W / w_scale), -127, 127).  rint() in the default FP
// environment is round-half-even — bitwise identical to np.rint.
// ---------------------------------------------------------------------------
double bdf_quantize_pair(int64_t total, const float* M, const float* W,
                         int8_t* M8, int8_t* W8) {
    float wmax = 0.0f;
    for (int64_t i = 0; i < total; ++i) {
        const float a = W[i] < 0 ? -W[i] : W[i];
        if (a > wmax) wmax = a;
    }
    const double w_scale = wmax > 0.0f ? (double)wmax / 127.0 : 1.0;
    const float ws = (float)w_scale;
    for (int64_t i = 0; i < total; ++i) {
        M8[i] = (int8_t)M[i];
        float q = rintf(W[i] / ws);
        if (q > 127.0f) q = 127.0f;
        if (q < -127.0f) q = -127.0f;
        W8[i] = (int8_t)q;
    }
    return w_scale;
}

int32_t bdf_write_sbm(const char* path, int64_t nrow, int64_t ncol,
                      int64_t nnz, const int32_t* rows,
                      const int32_t* cols) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    int64_t hdr[3] = {nrow, ncol, nnz};
    fwrite("SBM1", 1, 4, f);
    fwrite(hdr, 8, 3, f);
    fwrite(rows, 4, nnz, f);
    fwrite(cols, 4, nnz, f);
    fclose(f);
    return 0;
}

}  // extern "C"
