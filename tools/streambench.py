#!/usr/bin/env python
"""Streaming-inference latency/throughput bench (decode/streaming.py).

Measures the serving-critical numbers on the attached device at flagship
scale: per-chunk encoder step latency, end-to-end pipeline chunk latency
(encoder + incremental Viterbi feed), real-time factor, and the
algorithmic latency (context lookahead + chunk).

Usage: python tools/streambench.py [--batch 8] [--chunks 6,16,32]
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")
from tools._common import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--chunks", default="6,16,32",
                    help="comma list of chunk_out sizes (output frames)")
    ap.add_argument("--xconfig", default="configs/cnn_tdnn.xconfig")
    ap.add_argument("--graph-states", type=int, default=2048)
    ap.add_argument("--graph-arcs", type=int, default=16384)
    ap.add_argument("--pdfs", type=int, default=3080)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frame-shift-ms", type=float, default=10.0)
    ap.add_argument("--hclg", action="store_true",
                    help="HCLG-shaped graph (decodebench.synth_hclg_graph "
                         "word chains + LM fan-out) at --graph-states "
                         "scale; >64K arcs auto-selects the tree-ELL "
                         "kernels")
    ap.add_argument("--decoder", choices=["incremental", "windowed"],
                    default="incremental",
                    help="incremental = exact unbounded-memory "
                         "StreamingDecoder; windowed = bounded "
                         "WindowedStreamingDecoder (HCLG-scale serving "
                         "shape, traceback-delay commits)")
    ap.add_argument("--window", type=int, default=96,
                    help="windowed decoder: backpointer window / commit "
                         "delay in frames")
    ap.add_argument("--decode-only", action="store_true",
                    help="skip the acoustic encoder: feed synthetic "
                         "loglikes, isolating decoder feed cost (use "
                         "for S>=100K graph benches)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaldi_fp16_tpu.decode.graph import DecodingGraph
    from kaldi_fp16_tpu.decode.streaming import (
        StreamingDecoder, StreamingEncoder, WindowedStreamingDecoder,
    )
    from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
    from kaldi_fp16_tpu.models.model import build_model
    from kaldi_fp16_tpu.models.network import Network

    rng = np.random.default_rng(0)
    B = args.batch

    S, A = args.graph_states, args.graph_arcs
    if args.hclg:
        from decodebench import synth_hclg_graph
        graph = synth_hclg_graph(S, args.pdfs)
    else:
        # synthetic decode graph at bench scale
        states = [FstState(final=(0.0 if s > S - 8 else np.inf))
                  for s in range(S)]
        for a in range(A):
            s = int(rng.integers(0, S))
            states[s].arcs.append(FstArc(
                int(rng.integers(1, args.pdfs + 1)),
                float(rng.uniform(0.1, 2.0)),
                int(rng.integers(0, S)),
                olabel=int(rng.integers(0, 1000))))
        graph = DecodingGraph.from_fst(Fst(start=0, states=states))

    def make_decoder():
        if args.decoder == "windowed":
            return WindowedStreamingDecoder(graph, acoustic_scale=1.0,
                                            window=args.window)
        return StreamingDecoder(graph, acoustic_scale=1.0)

    if args.decode_only:
        # decoder-feed cost in isolation (synthetic posteriors)
        for co in [int(c) for c in args.chunks.split(",")]:
            dec = make_decoder()
            n_arcs = len(dec.arcs.src)
            ll = jnp.asarray(rng.normal(size=(B, co, args.pdfs))
                             .astype(np.float32))
            dst = dec.init(B)
            dst = dec.feed(dst, ll)     # compile + first commit path
            # reach steady state (window full, commits every feed)
            feeds = (args.window // co + 2 if args.decoder == "windowed"
                     else 1)
            for _ in range(feeds):
                dst = dec.feed(dst, ll)
            jax.block_until_ready(dst.score)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                dst = dec.feed(dst, ll)
                dst.score.block_until_ready()
            feed_ms = (time.perf_counter() - t0) / args.iters * 1e3
            chunk_audio_ms = co * 3 * args.frame_shift_ms  # output rate /3
            row = {
                "decoder": args.decoder, "chunk_out": co, "batch": B,
                "graph": {"S": graph.num_states, "A": n_arcs,
                          "hclg": bool(args.hclg)},
                "decode_feed_ms_per_chunk": round(feed_ms, 2),
                "audio_sec_per_s": round(B * chunk_audio_ms / feed_ms, 1),
                "rtf_per_stream": round(feed_ms / chunk_audio_ms, 4),
            }
            if args.decoder == "windowed":
                row["window_frames"] = dst.window_frames
                row["committed_frames"] = dst.committed_frames
                row["bp_window_mb"] = round(
                    dst.window_frames * graph.num_states * B * 4 / 2**20,
                    1)
            print(json.dumps(row), flush=True)
        return

    model = build_model(args.xconfig)
    net = Network(model)
    params, state = net.init(jax.random.PRNGKey(0))

    feat_dim = ivec_dim = None
    for inp in model.inputs():
        if inp.name == "ivector":
            ivec_dim = inp.spec.dim
        else:
            feat_dim = inp.spec.dim
    ivec = (jnp.asarray(rng.normal(size=(B, ivec_dim)).astype(np.float32))
            if ivec_dim else None)
    for co in [int(c) for c in args.chunks.split(",")]:
        enc = StreamingEncoder(model, params, state, chunk_out=co)
        dec = make_decoder()
        cin = enc.cin
        x = jnp.asarray(rng.normal(size=(B, cin, feat_dim))
                        .astype(np.float32))

        # warm up both compiles (encoder window fwd + decoder chunk)
        est = enc.init(ivec)
        dst = dec.init(B)
        for _ in range(enc.lag + 1):
            est, p = enc.feed(est, x)
        dst = dec.feed(dst, p)
        jax.block_until_ready((est.buf, dst.score))

        t0 = time.perf_counter()
        for _ in range(args.iters):
            est, p = enc.feed(est, x)
            p.block_until_ready()
        enc_ms = (time.perf_counter() - t0) / args.iters * 1e3

        t0 = time.perf_counter()
        for _ in range(args.iters):
            est, p = enc.feed(est, x)
            dst = dec.feed(dst, p)
            dst.score.block_until_ready()
        e2e_ms = (time.perf_counter() - t0) / args.iters * 1e3

        chunk_audio_ms = cin * args.frame_shift_ms
        alg_latency_ms = (enc.ctx_r + cin) * args.frame_shift_ms
        print(json.dumps({
            "chunk_out": co, "chunk_in": cin, "batch": B,
            "ctx": [enc.ctx_l, enc.ctx_r], "lag_chunks": enc.lag,
            "encoder_ms_per_chunk": round(enc_ms, 2),
            "e2e_ms_per_chunk": round(e2e_ms, 2),
            "rtf_per_stream": round(e2e_ms / chunk_audio_ms, 4),
            "streams_at_realtime": int(B * chunk_audio_ms // max(e2e_ms, 1e-9)),
            "algorithmic_latency_ms": alg_latency_ms,
            "graph": {"S": graph.num_states, "A": len(dec.arcs.src),
                      "hclg": bool(args.hclg)},
            "decoder": args.decoder,
        }), flush=True)


if __name__ == "__main__":
    main()
