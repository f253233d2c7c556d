// Network description of the fused positional-encoding NeRF field, read by
// its forward (fused_pe_field.cu).  The backward (fused_pe_field_bwd.cu)
// reads a program that ops/cuda/pe_bwd_plan.py builds from the same meta.
//
// The wrapper (ops/cuda/fused_pe_field.py pack_pe_field) passes a meta
// array: a header of ints, then 5 ints per layer (LayerDesc) in the order
// base..., top..., colour..., semantic....  Top layer 0 is the skip layer on
// [h | enc]; colour layer 0 takes [t | extras]; semantic layer 0 takes t.
#pragma once

#include "fused_layers.cuh"

namespace cropnerf {

enum {
  M_DIM, M_FREQS, M_ENC_COLS, M_ENC_PAD, M_DE, M_EX_PAD,
  M_N_BASE, M_N_TOP, M_N_COLOR, M_N_SEM,
  M_T_COLS, M_RGB_COLS, M_SEM_COLS, M_HMAX, M_HEADER
};

struct NetDesc {
  int dim, num_freqs, enc_cols, enc_pad, de, ex_pad;
  int n_base, n_top, n_color, n_sem;
  int t_cols, rgb_cols, sem_cols, hmax;
  LayerDesc L[MAX_LAYERS];

  __host__ __device__ int n_layers() const { return n_base + n_top + n_color + n_sem; }
  __host__ __device__ int top0() const { return n_base; }
  __host__ __device__ int color0() const { return n_base + n_top; }
  __host__ __device__ int sem0() const { return n_base + n_top + n_color; }
  // padded width of the trunk output t
  __host__ __device__ int t_pad() const { return L[n_base + n_top - 1].n; }
};

// heads=false reads only the trunk (fused_pe_density).
static bool parse(const int* meta, int meta_len, bool heads, NetDesc* d) {
  if (meta_len < M_HEADER) return false;
  d->dim = meta[M_DIM];
  d->num_freqs = meta[M_FREQS];
  d->enc_cols = meta[M_ENC_COLS];
  d->enc_pad = meta[M_ENC_PAD];
  d->de = meta[M_DE];
  d->ex_pad = meta[M_EX_PAD];
  d->n_base = meta[M_N_BASE];
  d->n_top = meta[M_N_TOP];
  d->n_color = heads ? meta[M_N_COLOR] : 0;
  d->n_sem = heads ? meta[M_N_SEM] : 0;
  d->t_cols = meta[M_T_COLS];
  d->rgb_cols = meta[M_RGB_COLS];
  d->sem_cols = meta[M_SEM_COLS];
  d->hmax = meta[M_HMAX];
  const int n_layers = d->n_base + d->n_top + d->n_color + d->n_sem;
  if (d->n_base < 1 || d->n_top < 1 || (heads && (d->n_color < 1 || d->n_sem < 1)))
    return false;
  if (d->num_freqs < 0 || d->num_freqs > 30 || d->dim < 1 ||
      d->enc_cols != d->dim * (1 + 2 * d->num_freqs) ||
      d->enc_pad < d->enc_cols || d->enc_pad % 16 || d->hmax % 16 ||
      d->hmax > MAX_WIDTH || (heads && (d->ex_pad < d->de || d->ex_pad % 16)))
    return false;
  if (meta_len != M_HEADER + 5 * n_layers) return false;
  return parse_layers(meta + M_HEADER, n_layers, d->L);
}

}  // namespace cropnerf
