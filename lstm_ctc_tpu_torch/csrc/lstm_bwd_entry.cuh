// The C entry points of K2 (lstm_bwd.cu), which K3 (lstm_bwd_fold.cu) runs
// first: the argument list as a macro, so that both files spell it once;
// K2's streamed plan (lstm_bwd_streamed.cu); and the weight-gradient passes
// of K2 and K13 (lstm_bwd_wgrad.cu).
#pragma once

#include <cuda_runtime.h>

#define LSTM_BWD_ARGS                                                          \
  int device, const void *gx, const void *lengths, const void *keep,          \
      const void *c_all, const void *h_all, const void *wh_sl,                \
      const void *proj_rows, const void *peep, float forget_bias,             \
      const void *dout, const void *dcfin, const void *dhfin, int steps,      \
      int batch, int units, int out_dim, int store_bf16, void *dgates,        \
      void *outb_st, void *doutp_st, void *dc_in, void *dh_in, void *dwh,     \
      void *dproj, void *dpeep, void *scratch, void *stream
#define LSTM_BWD_PASS                                                          \
  device, gx, lengths, keep, c_all, h_all, wh_sl, proj_rows, peep,            \
      forget_bias, dout, dcfin, dhfin, steps, batch, units, out_dim,          \
      store_bf16, dgates, outb_st, doutp_st, dc_in, dh_in, dwh, dproj, dpeep, \
      scratch, stream

extern "C" int lstm_bwd_f32(LSTM_BWD_ARGS);
extern "C" int lstm_bwd_bf16(LSTM_BWD_ARGS);

// K2's arguments as its launchers pass them on (lstm_bwd.cu, and its
// streamed plan in lstm_bwd_streamed.cu)
struct LstmBwdArgs {
  const void *gx, *lengths, *keep, *c_all, *h_all, *wh_sl, *proj_rows, *peep;
  float forget_bias;
  const void *dout, *dcfin, *dhfin;
  int steps, batch, units, out_dim;
  void *dgates, *outb_st, *doutp_st, *dc_in, *dh_in, *dwh, *dproj, *dpeep, *scratch;
  cudaStream_t stream;
};

// How the recurrence is launched: blocks a cluster, batch rows a cluster,
// clusters, those resident at once (the occupancy API's answer), dynamic
// shared memory a block (rows = 0: not with this R); the weight bytes a
// block holds, and streams from L2 a step.
struct LstmBwdLaunch {
  int blocks, rows, clusters, resident;
  size_t smem;
  long long held, streamed;
};

// K2's streamed plan (lstm_bwd_streamed.cu; bf16 compute, the store dtype
// by store_bf16) with C blocks a cluster and R rows, wh's resident 16-deep
// steps at most `cap` (-1: as many as fit; kAllHeld: all of them, or no
// plan): whether it fits (host arithmetic only), and its launch (R = 0: the
// largest R that fits; with `dry`, the launch is only planned), the
// peephole partials at `peep_part`.
bool lstm_bwd_streamed_fits(int units, int out_dim, bool has_proj, bool store_bf16, int C,
                            int rows, int cap);
cudaError_t lstm_bwd_streamed(const LstmBwdArgs& a, bool store_bf16, int C, int rows, int cap,
                              bool dry, float* peep_part, LstmBwdLaunch* how);
extern "C" long long lstm_bwd_scratch_floats(int steps, int batch, int units,
                                             int out_dim);

// dwh, dproj (when outb is not null) and dpeep (when peep_part is not null:
// peep_tiles partials of [2, 3, H], summed in order) from the recurrence's
// streams: h_all and dgates in the store dtype, the out_blk and dout_p
// stashes in the compute dtype; scratch: lstm_bwd_wgrad_scratch_floats.
extern "C" int lstm_bwd_wgrad(int bf16, int store_bf16, const void* h_all,
                              const void* keep, const void* dgates,
                              const void* outb, const void* doutp,
                              const float* peep_part, int peep_tiles, int steps,
                              int batch, int units, int out_dim, void* dwh,
                              void* dproj, void* dpeep, float* scratch,
                              void* stream);
extern "C" long long lstm_bwd_wgrad_scratch_floats(int steps, int batch, int units,
                                                   int out_dim);

// K13's dwz [L, 2P, 4H] and dproj [L, H, P] (when outb is not null) from the
// stack's streams: chain, h_all and dgates in the store dtype, hinit
// float32, the out_blk and dout_p stashes in the compute dtype; scratch:
// lstm_stack_wgrad_scratch_floats.
extern "C" int lstm_stack_wgrad(int bf16, int store_bf16, const void* chain,
                                const void* h_all, const float* hinit,
                                const void* dgates, const void* outb, const void* doutp,
                                int steps, int layers, int batch, int units, int out_dim,
                                void* dwz, void* dproj, float* scratch, void* stream);
extern "C" long long lstm_stack_wgrad_scratch_floats(int steps, int layers, int batch,
                                                     int units, int out_dim);

// K13's gate inputs before its recurrence: gxl [L-1, S, B, 4H] float32,
// gxl[l-1][s] = (layer l-1's chain at s-1, zero at s = 0)·wx_l for l >= 1,
// wx_l the first P rows of wz[l] (compute dtype), operands rounded to it.
extern "C" int lstm_stack_gate_inputs(int bf16, int store_bf16, const void* chain,
                                      const void* wz, int steps, int layers, int batch,
                                      int units, int out_dim, float* gxl, void* stream);
