#!/usr/bin/env python
"""decode — end-to-end decoding: egs -> acoustic model -> posteriors ->
WFST lattice decode -> (optional LM rescoring) -> words + WER.

The reference never implemented decoding (README.md:10 lists WFST decoding
as "kept" philosophy only); this is net-new per BASELINE.json config 5.

Usage:
  python tools/decode.py --egs 'data/cegs.*.ark' --xconfig cfg --pdfs P \\
      --graph HCLG.fst [--model nnet3.txt] [--acoustic-scale 1.0] \\
      [--beam 16] [--lattice-beam 8] [--ref ref.txt] [--nbest 0]

With no --egs/--graph it runs a synthetic demo (random 2-word graph).
`--ref` is a text file "utt-key word-id word-id ..." for WER scoring.
"""

import argparse
import sys

import _common  # noqa: F401
import numpy as np


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--egs")
    ap.add_argument("--graph")
    ap.add_argument("--xconfig")
    ap.add_argument("--model",
                    help="Kaldi model to load (binary .mdl/.raw or text)")
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--acoustic-scale", type=float, default=1.0)
    ap.add_argument("--beam", type=float, default=16.0)
    ap.add_argument("--lattice-beam", type=float, default=8.0)
    ap.add_argument("--ref", help="reference transcripts for WER")
    ap.add_argument("--nbest", type=int, default=0)
    ap.add_argument("--arpa-lm", help="ARPA LM for lattice rescoring")
    ap.add_argument("--words", help="words.txt symbol table for the LM")
    ap.add_argument("--lm-weight", type=float, default=1.0)
    ap.add_argument("--old-lm-weight", type=float, default=0.0,
                    help="weight on the graph's own scores when rescoring")
    ap.add_argument("--ctm", help="write best-path word timings + "
                    "confidences (lattice posteriors) as CTM to this "
                    "path (lattice modes only)")
    ap.add_argument("--frame-shift", type=float, default=0.03,
                    help="seconds per OUTPUT frame for CTM times "
                         "(0.01 input shift x subsampling 3)")
    ap.add_argument("--on-device", action="store_true",
                    help="batched exact decode on the device (arc-parallel, "
                         "epsilon-free graphs); with --nbest/--arpa-lm the "
                         "device emits exact beam-pruned lattices "
                         "(alpha+arc+beta criterion) and n-best/rescoring "
                         "run on them")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (correctness smokes)")
    args = ap.parse_args()

    if args.cpu:
        _common.force_cpu()

    import jax
    import jax.numpy as jnp
    from kaldi_fp16_tpu.decode.graph import DecodingGraph
    from kaldi_fp16_tpu.decode.lattice import LatticeDecodeOptions, LatticeDecoder
    from kaldi_fp16_tpu.decode.wer import wer

    if not (args.egs and args.graph and args.xconfig):
        print("demo mode: synthetic graph + posteriors "
              "(pass --egs/--graph/--xconfig for real decoding)")
        from tests.test_decoder import two_word_graph, loglikes_for
        if args.on_device:
            from tests.test_tpu_viterbi import eps_free_graph
            graph = DecodingGraph.from_fst(eps_free_graph())
        else:
            graph = DecodingGraph.from_fst(two_word_graph())
        posts = {"demo-utt": loglikes_for([1, 2, 3, 4])}
        refs = {"demo-utt": [1, 2]}
    else:
        from kaldi_fp16_tpu.io.dataloader import DataLoader, DataLoaderConfig
        from kaldi_fp16_tpu.models.model import build_model
        from kaldi_fp16_tpu.models.network import (
            forward, init_params, subsample_output,
        )
        graph = DecodingGraph.from_file(args.graph)
        model = build_model(args.xconfig)
        params, state = init_params(model, jax.random.PRNGKey(0))
        if args.model:
            from kaldi_fp16_tpu.models.kaldi_loader import (
                load_weights_from_file,
            )
            params, state, _ = load_weights_from_file(
                model, params, state, args.model)

        @jax.jit
        def acoustic(feats, ivecs):
            outs, _ = forward(model, params, state, feats, ivecs, train=False)
            return outs[model.chain_output().name]

        posts = {}
        dl = DataLoader(args.egs, DataLoaderConfig(batch_size=args.batch,
                                                   label_dim=args.pdfs))
        for batch in dl:
            out = acoustic(jnp.asarray(batch.features),
                           None if batch.ivectors is None
                           else jnp.asarray(batch.ivectors))
            out = subsample_output(out, 3, batch.left_context,
                                   batch.frames_per_seq)
            for i, key in enumerate(batch.keys):
                posts[key] = np.asarray(out[i], np.float64)
        refs = {}
        if args.ref:
            for line in open(args.ref):
                parts = line.split()
                if parts:
                    refs[parts[0]] = [int(w) for w in parts[1:]]

    lm = None
    if args.arpa_lm:
        from kaldi_fp16_tpu.decode.lm import read_arpa, read_symbol_table
        syms = read_symbol_table(args.words) if args.words else None
        lm, _ = read_arpa(args.arpa_lm, syms)
        print(f"ARPA LM loaded: order {lm.order}, {len(lm.ngrams)} n-grams")

    hyps, ref_list, hyp_list = {}, [], []
    ctm_f = open(args.ctm, "w") if args.ctm else None

    def emit_ctm(key, lat):
        """Kaldi-format CTM: key channel start dur word [conf]."""
        if ctm_f is None:
            return
        for start, dur, w, conf in lat.to_ctm(
                frame_shift=args.frame_shift,
                acoustic_scale=args.acoustic_scale):
            ctm_f.write(f"{key} 1 {start:.3f} {dur:.3f} {w} {conf:.3f}\n")

    if args.on_device:
        # batched exact decode on device, grouped by frame count so every
        # group is one [B, T, P] dispatch (no padding frames that would
        # alter paths).  Plain Viterbi unless lattices are needed.
        import numpy as _np
        if len(graph.eps_dst):
            from kaldi_fp16_tpu.decode.graph import remove_epsilons
            print(f"epsilon-removing the graph for on-device decode "
                  f"({len(graph.eps_dst)} eps arcs)")
            graph = remove_epsilons(graph)
        want_lattice = bool(args.nbest or args.arpa_lm or args.ctm)
        if want_lattice:
            from kaldi_fp16_tpu.decode.tpu_viterbi import DeviceLatticeDecoder
            ddec = DeviceLatticeDecoder(graph,
                                        acoustic_scale=args.acoustic_scale,
                                        lattice_beam=args.lattice_beam)
        else:
            from kaldi_fp16_tpu.decode.tpu_viterbi import SparseViterbiDecoder
            sdec = SparseViterbiDecoder(graph,
                                        acoustic_scale=args.acoustic_scale)
        by_t = {}
        for key, ll in posts.items():
            by_t.setdefault(ll.shape[0], []).append((key, ll))
        for t, group in sorted(by_t.items()):
            lls = _np.stack([ll for _, ll in group])
            if want_lattice:
                lats = ddec.decode_batch(lls)
                for (key, _), lat in zip(group, lats):
                    if args.arpa_lm:
                        from kaldi_fp16_tpu.decode.lattice import (
                            rescore_with_lm,
                        )
                        lat = rescore_with_lm(
                            lat, lm, lm_weight=args.lm_weight,
                            old_lm_weight=args.old_lm_weight)
                    words, cost = lat.best_path(
                        acoustic_scale=args.acoustic_scale)
                    hyps[key] = words
                    emit_ctm(key, lat)
                    extra = ""
                    if args.nbest:
                        nb = lat.n_best(args.nbest,
                                        acoustic_scale=args.acoustic_scale)
                        extra = "  nbest=" + "; ".join(
                            f"{w}@{c:.2f}" for w, c in nb)
                    print(f"{key}: {' '.join(map(str, words))}  "
                          f"(cost {cost:.3f}, {len(lat.arcs)} lattice "
                          f"arcs, on-device){extra}")
                    if key in refs:
                        ref_list.append(refs[key])
                        hyp_list.append(words)
            else:
                res = sdec.decode_batch(lls)
                for (key, _), r in zip(group, res):
                    hyps[key] = r["words"]
                    print(f"{key}: {' '.join(map(str, r['words']))}  "
                          f"(cost {r['total_cost']:.3f}, on-device)")
                    if key in refs:
                        ref_list.append(refs[key])
                        hyp_list.append(r["words"])
        if ref_list:
            report = wer(ref_list, hyp_list)
            print("WER: " + " ".join(f"{k}={v}" for k, v in report.items()))
        if ctm_f:
            ctm_f.close()
            print(f"wrote CTM: {args.ctm}")
        return

    dec = LatticeDecoder(graph, LatticeDecodeOptions(
        beam=args.beam, lattice_beam=args.lattice_beam,
        acoustic_scale=args.acoustic_scale))
    for key, ll in posts.items():
        lat = dec.decode(ll)
        if lm is not None:
            from kaldi_fp16_tpu.decode.lattice import rescore_with_lm
            lat = rescore_with_lm(lat, lm, lm_weight=args.lm_weight,
                                  old_lm_weight=args.old_lm_weight)
        words, cost = lat.best_path(acoustic_scale=args.acoustic_scale)
        hyps[key] = words
        emit_ctm(key, lat)
        extra = ""
        if args.nbest:
            nb = lat.n_best(args.nbest, acoustic_scale=args.acoustic_scale)
            extra = "  nbest=" + "; ".join(
                f"{w}@{c:.2f}" for w, c in nb)
        print(f"{key}: {' '.join(map(str, words))}  (cost {cost:.3f},"
              f" {len(lat.arcs)} lattice arcs){extra}")
        if key in refs:
            ref_list.append(refs[key])
            hyp_list.append(words)
    if ref_list:
        report = wer(ref_list, hyp_list)
        print("WER: " + " ".join(f"{k}={v}" for k, v in report.items()))
    if ctm_f:
        ctm_f.close()
        print(f"wrote CTM: {args.ctm}")


if __name__ == "__main__":
    main()
