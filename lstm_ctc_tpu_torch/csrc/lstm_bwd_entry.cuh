// The C entry points of K2 (lstm_bwd.cu), which K3 (lstm_bwd_fold.cu) runs
// first: the argument list as a macro, so that both files spell it once.
#pragma once

#define LSTM_BWD_ARGS                                                          \
  int device, const void *gx, const void *lengths, const void *keep,          \
      const void *c_all, const void *h_all, const void *wh, const void *wht,  \
      const void *projt, const void *peep, float forget_bias,                 \
      const void *dout, const void *dcfin, const void *dhfin, int steps,      \
      int batch, int units, int out_dim, int store_bf16, void *dgates,        \
      void *cnew_st, void *outb_st, void *doutp_st, void *dc_in, void *dh_in, \
      void *dwh, void *dproj, void *dpeep, void *scratch, void *stream
#define LSTM_BWD_PASS                                                          \
  device, gx, lengths, keep, c_all, h_all, wh, wht, projt, peep, forget_bias, \
      dout, dcfin, dhfin, steps, batch, units, out_dim, store_bf16, dgates,   \
      cnew_st, outb_st, doutp_st, dc_in, dh_in, dwh, dproj, dpeep, scratch,   \
      stream

extern "C" int lstm_bwd_f32(LSTM_BWD_ARGS);
extern "C" int lstm_bwd_bf16(LSTM_BWD_ARGS);
extern "C" long long lstm_bwd_scratch_floats(int steps, int batch, int units,
                                             int out_dim);
