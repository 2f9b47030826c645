// The C entry points of K2 (lstm_bwd.cu), which K3 (lstm_bwd_fold.cu) runs
// first: the argument list as a macro, so that both files spell it once;
// and K2's weight-gradient pass (lstm_bwd_wgrad.cu).
#pragma once

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
