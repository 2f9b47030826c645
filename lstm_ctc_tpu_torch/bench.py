"""Benchmark: acoustic frames/sec/chip of the port's flagship train step.

    python -m lstm_ctc_tpu_torch.bench [--smoke] [--device cuda|cpu]
        [--steps N]

The port's counterpart of ``bench.py``, with its rows, keys and JSON line.
It times the whole train step (forward, CTC, backward, clip, adam) through
``train/graph.make_train_step`` on the card:

  * ``flagship_b32_t384``     B=32, T=384 unpacked (the headline ``value``)
  * ``flagship_b64_t384``     B=64 unpacked
  * ``recipe_packed_pf3_b32`` the shipped recipe's packed rows (pack factor
                              3) from ``BucketedBatcher`` over a WSJ-like
                              length mix; REAL frames/s, plus ``fill``
  * ``mesh_dp<n>_b32x<n>_t384`` only under a process group of n > 1 ranks
                              (``python -m torch.distributed.run``): the
                              data-parallel step (``parallel/mesh.py``) on a
                              global batch of 32·n, global and per-chip
  * ``lstm_b32_t384``, ``cudnnlstm_b32_t384``, ``lstm_bn_b32_t384``
                              the unidirectional families
  * ``streaming_lstm_b1_chunk16`` one streaming chunk of the causal ``lstm``
                              at batch 1 with carried states: ms per chunk,
                              audio seconds per chunk, real-time factor

plus the inference forward (``forward_frames_per_sec``).  Each row's MFU is
the analytic model FLOPs a frame (``model_fwd_flops_per_frame``, 3x the
forward for forward + backward) times frames/s over the H100's dense bf16
peak of 989 TFLOP/s; the rows run in the port's default dtypes (bf16
compute on the card).

Timing: the step is warmed (every bucket shape of the packed row), then
one window of ``--steps`` steps is timed on the host clock, ending in
``torch.cuda.synchronize()``.  Prints the cumulative JSON line after every
row; the last stdout line is the result.  A row that fails is not
swallowed: the line of what finished is printed and the bench exits
non-zero, as it does with no card unless ``--device cpu`` is given.
``--smoke`` selects tiny shapes (2 layers of 16, 4 experts, B=4, T=32):
every row runs, the numbers mean nothing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

ASSUMED_V100_FRAMES_PER_SEC = 15000.0
H100_BF16_PEAK_FLOPS = 989e12
STEPS = 100


def model_fwd_flops_per_frame(config):
    """Analytic forward FLOPs per acoustic frame (matmuls only; 2·M·N·K
    per matmul).  BLSTM: per direction per layer, input proj D·4H,
    recurrent P·4H, projection H·P; unidirectional families: one
    direction, layer input = P; MoE head: gate 2P·E + experts
    2P·(E·V); dense head: head_in·V."""
    d_in = config["input_dim"] * (1 + config["left_context"]
                                  + config["right_context"])
    h = config["num_neurons"]
    p = config.get("num_projects") or h
    v = config["num_targets"]
    e = config.get("num_experts", 0) or 0
    layers = config["num_layers"]
    bidi = config.get("nnet_type", "blstm") == "blstm"
    ndir = 2 if bidi else 1
    head_in = (2 * p) if bidi else p

    def per_dir(d):
        f = 2 * d * 4 * h + 2 * p * 4 * h
        if config.get("num_projects"):
            f += 2 * h * p
        return f

    flops = ndir * per_dir(d_in)                    # layer 0
    flops += ndir * per_dir(head_in) * (layers - 1)  # stack
    if e > 0:
        flops += 2 * head_in * e + 2 * head_in * (e * v)
    else:
        flops += 2 * head_in * v
    return flops


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them (or
    ``cpu``)."""
    if device.type != "cuda":
        return "cpu"
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return "%s (nvidia-smi: %s)" % (torch.cuda.get_device_name(device), smi)


class Bench:
    """The rows, on one device, with ``steps`` steps a timed window."""

    def __init__(self, device, steps: int, smoke: bool):
        self.device, self.steps, self.smoke = device, steps, smoke

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def seconds_per_step(self, run_once, steps=None, warm=1):
        """Warm ``run_once`` ``warm`` times, then time one window of
        ``steps`` calls that ends in a synchronisation."""
        for _ in range(warm):
            run_once()
        self.sync()
        steps = steps or self.steps
        start = time.perf_counter()
        for _ in range(steps):
            run_once()
        self.sync()
        return (time.perf_counter() - start) / steps

    def on_device(self, arrays):
        import torch
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def trainer(self, config):
        """(params, opt_state, net_state, train_step) of ``config`` on
        random weights from a seed, adam 1e-3."""
        import torch
        from .models import init_model
        from .train.checkpoint import tree_map
        from .train.graph import make_train_step
        params, net_state = init_model(torch.Generator().manual_seed(0),
                                       config, self.device)
        params = tree_map(lambda t: t.float().requires_grad_(), params)
        init_opt, train_step = make_train_step(config, learn_rate=1e-3,
                                               optimizer="adam")
        return params, init_opt(params), net_state, train_step

    def train_rate(self, config, batches, frames, steps=None):
        """Frames/s of the train step over ``batches`` in turn (each warmed
        first), ``frames`` the frames counted a batch."""
        import torch
        params, opt_state, net_state, train_step = self.trainer(config)
        generator = torch.Generator(self.device).manual_seed(1)
        state = {"s": net_state, "i": 0}

        def run_once():
            i = state["i"] % len(batches)
            state["i"] += 1
            _, _, state["s"], _ = train_step(params, opt_state, state["s"],
                                             generator, batches[i])

        steps = steps or self.steps
        dt = self.seconds_per_step(run_once, steps,
                                   warm=max(2, len(batches)))
        return float(np.mean(frames)) / dt

    def unpacked(self, config, batch_size, time_steps):
        from .graft_entry import _example_batch
        batch = self.on_device(_example_batch(config, batch=batch_size,
                                              time_steps=time_steps))
        return self.train_rate(config, [batch], [batch_size * time_steps])

    def packed(self, config, batch_size, pack_factor):
        """REAL frames/s over packed rows from the batcher (windowed
        best-fit) on a WSJ-like length mix, and the mean fill."""
        from .host.data import BucketedBatcher, RecordMeta
        config = dict(config, packed_slots_rank_major=True)
        rng_np = np.random.RandomState(0)
        n_utts = max(512, 8 * batch_size * max(pack_factor or 1, 1))
        len_lo, len_hi = 200, 1152
        if self.smoke:
            n_utts, (len_lo, len_hi) = 4 * batch_size, (30, 120)
        raw_dim = config["input_dim"]
        lengths = rng_np.randint(len_lo, len_hi, size=n_utts)
        label_lens = np.maximum(2, lengths // 30)
        metas = [RecordMeta("u%03d" % i, int(t), raw_dim, True, "mem", i)
                 for i, t in enumerate(lengths)]
        feats = {m.key: rng_np.randn(m.num_rows, raw_dim).astype(np.float32)
                 for m in metas}
        labs = {m.key: rng_np.randint(
            0, config["num_targets"] - 1, label_lens[i]).astype(np.int32)
            for i, m in enumerate(metas)}

        class Loader:
            def load(self, meta):
                return meta.key, feats[meta.key], labs[meta.key]

            def close(self):
                pass

        batcher = BucketedBatcher(
            metas, batch_size=batch_size,
            left_context=config["left_context"],
            right_context=config["right_context"],
            subsample=config["subsample"],
            label_lengths=[len(labs[m.key]) for m in metas],
            pack_factor=pack_factor)
        batches, real_frames, padded = [], [], []
        for bucket_idx, rows in batcher.batch_plan(shuffle=True,
                                                   seed=0)[:6]:
            b = batcher.assemble(bucket_idx, rows, Loader())
            arrays = {"nnet_input": b.nnet_input,
                      "sequence_length": b.sequence_length,
                      "nnet_target": b.nnet_target,
                      "target_length": b.target_length}
            if (pack_factor or 1) > 1:
                arrays["reset_mask"] = b.reset_mask
                arrays["utt_time_index"] = b.utt_time_index
                arrays["utt_sequence_length"] = b.utt_sequence_length
                real = int(np.sum(b.utt_sequence_length))
            else:
                real = int(np.sum(b.sequence_length))
            batches.append(self.on_device(arrays))
            real_frames.append(real)
            padded.append(b.nnet_input.shape[0] * b.nnet_input.shape[1])
        fill = float(np.mean([f / p for f, p in zip(real_frames, padded)]))
        steps = (2 if self.smoke else 9) * len(batches)
        return self.train_rate(config, batches, real_frames, steps), fill

    def mesh(self, config, batch_per_rank, time_steps):
        """The data-parallel step over the process group: a global batch of
        batch_per_rank·n rows split over the n ranks; → (global frames/s,
        n)."""
        from . import parallel
        from .graft_entry import _example_batch
        from .models.cells import DropoutStreams
        n = parallel.world_size()
        global_batch = batch_per_rank * n
        batch = parallel.shard_batch(_example_batch(
            config, batch=global_batch, time_steps=time_steps), self.device)
        params, opt_state, net_state, train_step = self.trainer(config)
        streams = DropoutStreams.for_rank(self.device, 1, parallel.rank())
        state = {"s": net_state}

        def run_once():
            _, _, state["s"], _ = train_step(params, opt_state, state["s"],
                                             streams, batch)

        return global_batch * time_steps / self.seconds_per_step(run_once), n

    def streaming(self, config, chunk_rows=16):
        """One streaming chunk step of the causal ``lstm`` at batch 1 with
        carried states; → (seconds a chunk, audio seconds a chunk)."""
        import torch
        from .models import init_model
        from .models.streaming import StreamingSession
        cfg = dict(config, nnet_type="lstm", use_peepholes=True,
                   num_experts=0, use_bn=False, dropout_rate=1.0)
        if not cfg.get("num_projects"):
            cfg["num_projects"] = cfg["num_neurons"]
        params, net_state = init_model(torch.Generator().manual_seed(0), cfg,
                                       self.device)
        sess = StreamingSession(params, net_state, cfg, chunk_size=chunk_rows)
        feat_dim = cfg["input_dim"] * (1 + cfg["left_context"]
                                       + cfg["right_context"])
        rng_np = np.random.RandomState(0)
        x = torch.from_numpy(rng_np.randn(1, chunk_rows, feat_dim).astype(
            np.float32)).to(self.device)
        seq_len = torch.tensor([chunk_rows], dtype=torch.int32,
                               device=self.device)
        state = {"s": sess._init_states()}

        def run_once():
            with torch.no_grad():
                _, state["s"] = sess._model_chunk(state["s"], x, seq_len)

        dt = self.seconds_per_step(run_once)
        audio_s = chunk_rows * max(cfg.get("subsample", 1) or 1, 1) * 0.01
        return dt, audio_s

    def forward(self, config, batch_size, time_steps):
        """Inference frames/s of the model forward (``train=False``)."""
        import torch
        from .graft_entry import _example_batch
        from .models import apply_model, init_model
        params, net_state = init_model(torch.Generator().manual_seed(0),
                                       config, self.device)
        batch = self.on_device(_example_batch(config, batch=batch_size,
                                              time_steps=time_steps))

        def run_once():
            with torch.no_grad():
                apply_model(params, net_state, batch["nnet_input"],
                            batch["sequence_length"], config, train=False)

        return batch_size * time_steps / self.seconds_per_step(run_once)


def run(args) -> None:
    from . import cli, parallel
    from .graft_entry import FLAGSHIP_CONFIG

    device = cli.resolve_device(args.device)
    with cli.data_parallel(device):
        config = dict(FLAGSHIP_CONFIG, dropout_rate=1.0)
        bench_b, bench_t = 32, 384
        if args.smoke:
            # CI path: tiny shapes, every row exercised, numbers meaningless
            config.update(num_layers=2, num_neurons=16, num_projects=16,
                          num_experts=4)
            bench_b, bench_t = 4, 32
        bench = Bench(device, args.steps or (4 if args.smoke else STEPS),
                      args.smoke)
        train_flops = 3 * model_fwd_flops_per_frame(config)

        def mfu(fps, flops=train_flops):
            return round(fps * flops / H100_BF16_PEAK_FLOPS, 4)

        rows = []
        result = {
            "metric": "train_frames_per_sec_per_chip",
            "value": None,
            "unit": "frames/s",
            "mfu": None,
            "vs_baseline": None,
            "baseline_note": "vs_baseline divides by an ASSUMED 15k "
                             "frames/s V100/TF1.8 figure — the conservative "
                             "end of a FLOP-roofline bracket (15-40k); the "
                             "reference publishes accuracy only "
                             "(BASELINE.md)",
            "configs": rows,
            "model_train_mflops_per_frame": round(train_flops / 1e6, 1),
            "mfu_peak_note": "MFU vs the H100's dense bf16 peak 989 TFLOP/s; "
                             "counts useful fwd+bwd matmul FLOPs (3x fwd), "
                             "excluding remat recompute",
            "forward_frames_per_sec": None,
            "device": device_name(device),
        }

        def emit():
            print(json.dumps(result), flush=True)

        def row(fn):
            # a failed row is not swallowed: the line of what finished is
            # printed, then the error ends the bench with a non-zero exit
            try:
                rows.append(fn())
            except BaseException:
                emit()
                raise
            emit()

        def headline():
            fps32 = bench.unpacked(config, bench_b, bench_t)
            result["value"] = round(fps32, 1)
            result["mfu"] = mfu(fps32)
            result["vs_baseline"] = round(
                fps32 / ASSUMED_V100_FRAMES_PER_SEC, 3)
            return {"config": "flagship_b32_t384",
                    "frames_per_sec": round(fps32, 1), "mfu": mfu(fps32)}

        def row_b64():
            fps64 = bench.unpacked(config, 2 * bench_b, bench_t)
            return {"config": "flagship_b64_t384",
                    "frames_per_sec": round(fps64, 1), "mfu": mfu(fps64)}

        def row_packed():
            fps_packed, fill = bench.packed(config, bench_b, 3)
            return {"config": "recipe_packed_pf3_b32",
                    "frames_per_sec": round(fps_packed, 1),
                    "mfu": mfu(fps_packed), "fill": round(fill, 3),
                    "note": "REAL frames/s (padding excluded) — shipped "
                            "recipe config (egs/wsj/run_wsj_phn.sh "
                            "pack_factor=3)"}

        def row_mesh():
            fps_mesh, n = bench.mesh(config, bench_b, bench_t)
            return {"config": "mesh_dp%d_b%dx%d_t384" % (n, bench_b, n),
                    "frames_per_sec": round(fps_mesh, 1),
                    "frames_per_sec_per_chip": round(fps_mesh / n, 1),
                    "mfu": mfu(fps_mesh / n),
                    "note": "global frames/s over a %d-rank data-parallel "
                            "process group; mfu is per-chip" % n}

        def fam_row(label, fam, proj, peep, use_bn=False):
            if args.smoke and proj:
                proj = config["num_projects"]
            fam_cfg = dict(config, nnet_type=fam, num_projects=proj,
                           use_peepholes=peep, num_experts=0, use_bn=use_bn)
            fps = bench.unpacked(fam_cfg, bench_b, bench_t)
            return {"config": "%s_b32_t384" % label,
                    "frames_per_sec": round(fps, 1),
                    "mfu": mfu(fps, 3 * model_fwd_flops_per_frame(fam_cfg))}

        def row_streaming():
            chunk_rows = 4 if args.smoke else 16
            dt, audio_s = bench.streaming(config, chunk_rows=chunk_rows)
            return {"config": "streaming_lstm_b1_chunk%d" % chunk_rows,
                    "ms_per_chunk": round(dt * 1e3, 3),
                    "audio_s_per_chunk": round(audio_s, 3),
                    "real_time_factor": round(audio_s / dt, 4),
                    "note": "chunk-step latency of the causal serving path "
                            "(carried states, batch 1), host clock to a "
                            "synchronisation; RTF = audio seconds per chunk "
                            "/ latency"}

        row(headline)
        row(row_b64)
        row(row_packed)
        if parallel.world_size() > 1:
            row(row_mesh)
        for label, fam, proj, peep, bn in (
                ("lstm", "lstm", 320, True, False),
                ("cudnnlstm", "cudnnlstm", None, False, False),
                ("lstm_bn", "lstm", 320, True, True)):
            row(lambda label=label, fam=fam, proj=proj, peep=peep, bn=bn:
                fam_row(label, fam, proj, peep, use_bn=bn))
        row(row_streaming)
        result["forward_frames_per_sec"] = round(
            bench.forward(config, bench_b, bench_t), 1)
        emit()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="frames/s of the port's train step, bench.py's rows")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes: every row runs, numbers meaningless")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of a timed window (default %d, 4 with "
                         "--smoke)" % STEPS)
    run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
