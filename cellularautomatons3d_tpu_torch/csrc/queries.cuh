// Per-query operands read where the lighting code leaves them, for K5
// (shadow_multi.cu) and K3 (cell_state.cu).
//
// The lighting passes (render/render_slab.py) make each query's operands
// as separate tensors: a start point [H, W, 3] f32, a target [H, W, 3] or
// one light position [3], cell coordinates [H, W, 3] int32 or int64, an
// active mask [H, W] bool.  K2 takes them stacked and cast by torch
// ([nq, 3, H, W]); K5 and K3 take a small table of pointers and strides
// instead, passed by value as a kernel parameter, and read each element
// where it lies.  The host side fills the table from flat int64 rows (one
// row per query, layouts below), so the C entry points need no struct that
// the caller must mirror.

#pragma once

#include <cstdint>

namespace ca3d {

constexpr int kMaxQueries = 8;  // queries per launch of K5 or K3

// Component c (0..2) of pixel p (= y * W + x) of a per-pixel vector operand
// at ptr[p * pix + c * comp], in elements: pix = 3, comp = 1 for a
// contiguous [H, W, 3] tensor, pix = 1, comp = H * W for a [3, H, W] slice
// seen as [H, W, 3], pix = 0 for one vector shared by every pixel ([3]).
// Cells are int32 or int64 (wide), as the caller made them; a value is read
// as int64, so any coordinate keeps its value.
struct PixelVec {
  const float* ptr;
  long long pix, comp;
  __device__ __forceinline__ float at(long long p, int c) const {
    return __ldg(ptr + p * pix + c * comp);
  }
};

struct PixelCells {
  const void* ptr;
  long long pix, comp;
  int wide;
  __device__ __forceinline__ long long at(long long p, int c) const {
    const long long i = p * pix + c * comp;
    return wide ? __ldg(static_cast<const long long*>(ptr) + i)
                : (long long)__ldg(static_cast<const int*>(ptr) + i);
  }
};

// One occlusion query of K5 and its host row of 11 int64:
// start ptr, pix, comp; target ptr, pix, comp; excl ptr, pix, comp, wide;
// active ptr ([H, W] bool, contiguous).
struct OcclusionQuery {
  PixelVec start, target;
  PixelCells excl;
  const uint8_t* active;
};
constexpr int kOcclusionRow = 11;

struct OcclusionQueries {
  OcclusionQuery q[kMaxQueries];
};

// One lookup of K3 and its host row of 5 int64: coords ptr, pix, comp,
// wide; active ptr ([H, W] bool, contiguous).
struct CellQuery {
  PixelCells coords;
  const uint8_t* active;
};
constexpr int kCellRow = 5;

struct CellQueries {
  CellQuery q[kMaxQueries];
};

inline PixelVec pixel_vec(const long long* row) {
  return PixelVec{reinterpret_cast<const float*>(row[0]), row[1], row[2]};
}

inline PixelCells pixel_cells(const long long* row) {
  return PixelCells{reinterpret_cast<const void*>(row[0]), row[1], row[2],
                    (int)row[3]};
}

inline OcclusionQueries occlusion_queries(const long long* rows, int nq) {
  OcclusionQueries qs = {};
  for (int i = 0; i < nq; ++i) {
    const long long* r = rows + i * kOcclusionRow;
    qs.q[i].start = pixel_vec(r);
    qs.q[i].target = pixel_vec(r + 3);
    qs.q[i].excl = pixel_cells(r + 6);
    qs.q[i].active = reinterpret_cast<const uint8_t*>(r[10]);
  }
  return qs;
}

inline CellQueries cell_queries(const long long* rows, int nq) {
  CellQueries qs = {};
  for (int i = 0; i < nq; ++i) {
    const long long* r = rows + i * kCellRow;
    qs.q[i].coords = pixel_cells(r);
    qs.q[i].active = reinterpret_cast<const uint8_t*>(r[4]);
  }
  return qs;
}

}  // namespace ca3d
