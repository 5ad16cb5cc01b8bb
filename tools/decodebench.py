#!/usr/bin/env python
"""decodebench — batched on-device dense Viterbi decoding throughput.

The reference never implemented decoding at all (SURVEY.md §6: "no decoder
exists in the reference"), so there is no baseline to beat — this measures
the net-new device decode path: a synthetic epsilon-free decoding graph with
--states states, random loglikes [batch, frames, pdfs], one jitted
max-plus lax.scan on device + host traceback, reported as audio-sec/s
(100 frames = 1 audio second).

Usage: python tools/decodebench.py [--states 2048] [--pdfs 512]
       [--batch 32] [--frames 500] [--arcs-per-state 8] [--iters 3]
"""

import argparse
import json
import time

import _common  # noqa: F401
import numpy as np


def synth_graph(S: int, P: int, E: int, seed: int = 0):
    """Random epsilon-free decoding graph: every state emits E arcs with
    random pdf ilabels (1..P) and occasional word olabels; all states
    final so random paths terminate."""
    from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState

    rng = np.random.default_rng(seed)
    states = [FstState() for _ in range(S)]
    for s in range(S):
        dsts = rng.choice(S, size=E, replace=False)
        for d in dsts:
            states[s].arcs.append(FstArc(
                int(rng.integers(1, P + 1)),
                float(rng.uniform(0.0, 2.0)),
                int(d),
                olabel=int(rng.integers(0, 100) < 20)
                and int(rng.integers(1, 1000))))
        states[s].final = float(rng.uniform(0.0, 1.0))
    return Fst(start=0, states=states)


def synth_hclg_graph(S: int, P: int, seed: int = 0, word_len: int = 10,
                     lm_branching: int = 20):
    """HCLG-shaped epsilon-free graph at arbitrary scale, built directly
    as flat arrays (no per-arc Python objects): W = S/word_len word HMM
    chains (self-loop + advance per state), word-end states fan out to
    lm_branching word-start states with the word's olabel on the exit
    arc.  This reproduces a real decoding graph's structure class —
    locality inside words, sparse long-range LM fan-out — the way
    make_phone_lm_den_fst does for den.fst."""
    from kaldi_fp16_tpu.decode.graph import DecodingGraph

    rng = np.random.default_rng(seed)
    W = max(1, S // word_len)
    S = W * word_len
    sid = np.arange(S, dtype=np.int64)
    k = sid % word_len
    word = sid // word_len
    pdf_of_state = (sid % P).astype(np.int64) + 1      # ilabel = pdf+1

    srcs, dsts, ils, ols, ws = [], [], [], [], []
    # self-loops
    srcs.append(sid); dsts.append(sid); ils.append(pdf_of_state)
    ols.append(np.zeros(S, np.int64))
    ws.append(rng.uniform(0.2, 1.0, S))
    # in-word advance
    adv = sid[k < word_len - 1]
    srcs.append(adv); dsts.append(adv + 1); ils.append(pdf_of_state[adv + 1])
    ols.append(np.zeros(len(adv), np.int64))
    ws.append(rng.uniform(0.2, 1.0, len(adv)))
    # word-end LM fan-out (emitting into next word's first state, carrying
    # THIS word's olabel)
    ends = sid[k == word_len - 1]
    succ = rng.integers(0, W, size=(len(ends), lm_branching))
    fan_src = np.repeat(ends, lm_branching)
    fan_dst = succ.reshape(-1) * word_len
    srcs.append(fan_src); dsts.append(fan_dst)
    ils.append(pdf_of_state[fan_dst])
    ols.append(np.repeat(word[ends] + 1, lm_branching))
    ws.append(rng.uniform(0.5, 4.0, len(fan_src)))

    return DecodingGraph.from_arrays(
        num_states=S, start=0,
        src=np.concatenate(srcs), dst=np.concatenate(dsts),
        ilabel=np.concatenate(ils), olabel=np.concatenate(ols),
        weight=np.concatenate(ws),
        final_cost=rng.uniform(0.0, 1.0, S))


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--states", type=int, default=2048)
    ap.add_argument("--pdfs", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--arcs-per-state", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--hclg", action="store_true",
                    help="HCLG-shaped graph (word chains + LM fan-out) "
                         "built as flat arrays; use for --states >= 10K")
    ap.add_argument("--on-device-ll", action="store_true",
                    help="generate loglikes on device (production shape: "
                         "the acoustic model's output is already "
                         "device-resident; excludes the host->device "
                         "feature upload from the measurement)")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "segment", "ell", "tree"],
                    help="sparse-kernel layout (tree = capped multi-level "
                         "scatter-free reductions, the HCLG-scale kernel; "
                         "auto picks segment/tree by arc count)")
    ap.add_argument("--dense", action="store_true",
                    help="use the dense [S,S] decoder (measured ~23x "
                         "slower at the default scale)")
    ap.add_argument("--lattice", action="store_true",
                    help="exact on-device lattice generation "
                         "(alpha+beta scans + bit-packed arc masks + "
                         "host assembly) instead of best-path Viterbi")
    ap.add_argument("--lattice-beam", type=float, default=4.0)
    ap.add_argument("--transfer", default="auto",
                    choices=["auto", "dense", "compact"],
                    help="lattice mask D2H: compact = device-side "
                         "nonzero-byte extraction (ships ~5 bytes per "
                         "kept mask byte instead of the full packed "
                         "tensor, 143 MB at B=8 on the HCLG graph)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (correctness smokes)")
    args = ap.parse_args()

    if args.cpu:
        _common.force_cpu()

    from kaldi_fp16_tpu.decode.graph import DecodingGraph
    from kaldi_fp16_tpu.decode.tpu_viterbi import (
        DenseViterbiDecoder, DeviceLatticeDecoder, SparseViterbiDecoder,
    )

    S, P, B, T = args.states, args.pdfs, args.batch, args.frames
    t0 = time.perf_counter()
    if args.hclg:
        graph = synth_hclg_graph(S, P)
        S = graph.num_states
    else:
        graph = DecodingGraph.from_fst(
            synth_graph(S, P, args.arcs_per_state))
    if args.lattice:
        dec = DeviceLatticeDecoder(graph, acoustic_scale=1.0,
                                   lattice_beam=args.lattice_beam,
                                   layout=args.layout,
                                   transfer=args.transfer)
    elif args.dense:
        dec = DenseViterbiDecoder(graph, acoustic_scale=1.0)
    else:
        dec = SparseViterbiDecoder(graph, acoustic_scale=1.0,
                                   layout=args.layout)
    build_s = time.perf_counter() - t0

    if args.on_device_ll:
        import jax
        import jax.numpy as jnp
        ll = jax.random.normal(jax.random.PRNGKey(1), (B, T, P),
                               dtype=jnp.float32)
        ll.block_until_ready()
    else:
        rng = np.random.default_rng(1)
        ll = rng.normal(size=(B, T, P)).astype(np.float32)

    # warm (compile)
    res = dec.decode_batch(ll)
    if not args.lattice:
        assert all(r["final_reached"] for r in res)

    t0 = time.perf_counter()
    for _ in range(args.iters):
        res = dec.decode_batch(ll)
    dt = (time.perf_counter() - t0) / args.iters

    audio_s = B * T / 100.0
    print(json.dumps({
        "metric": "decode_audio_sec_per_s",
        "value": round(audio_s / dt, 1),
        "unit": ("audio-sec/s (exact on-device lattices)" if args.lattice
                 else "audio-sec/s (exact batched Viterbi, on-device "
                      "traceback)"),
        "detail": {"decoder": ("lattice" if args.lattice else
                               "dense" if args.dense else "sparse"),
                   "states": S, "pdfs": P, "batch": B, "frames": T,
                   "decode_ms": round(dt * 1e3, 1),
                   "graph_build_s": round(build_s, 2),
                   **({"mean_lattice_arcs": round(float(np.mean(
                           [len(l.arcs) for l in res])), 1)}
                      if args.lattice else
                      {"mean_cost": round(float(np.mean(
                          [r["total_cost"] for r in res])), 2)})},
    }))


if __name__ == "__main__":
    main()
