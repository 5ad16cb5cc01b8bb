#!/usr/bin/env python
"""chip_smoke — the flagship chain training path, once, on one GPU.

Drives the system through the entry points a user calls, at the full
width of `configs/cnn_tdnn.xconfig` (cnn1-6 + tdnnf7-21, dual heads, 3080
pdfs) with its 7052-state phone-LM den graph, weights random from a
seed, and checks every phase against the repo's plain references:

  train   synthetic cegs ark bytes -> DataLoader -> Trainer.place_batch /
          train_batch, epochs over two B=128 batches, 15 steps after
          warm-up; the objective on them must improve, and a second run
          from the same seed must repeat the losses bit for bit
  den     structured den forward-backward (N=128, T=49) vs the plain fp32
          jax.numpy reference, and on a slice (N=2, T=8) vs the fp64
          oracle; two runs must be bit-equal
  num     numerator forward-backward (B=128, A=256) vs the fp64 oracle
  fwd     flagship forward in bf16 vs fp32 HIGHEST (B=128, T=150)
  decode  SparseViterbiDecoder (segment and tree layouts) and
          DeviceLatticeDecoder on decodebench's default graph vs the host
          Viterbi decoder

`--four-cards` runs only the data-parallel training path over four cards
and its comparison with the one-card trajectory from the same seed, held
to the spread of one-card runs from nudged parameters.

One process holds the card(s); child processes (nvidia-smi, the egs
generator, loader workers) stay off them.  XLA is asked for deterministic
GPU ops (`DETERMINISM_FLAG`).  It exits non-zero, and prints no result
line, when JAX finds no GPU or any phase fails.  The last line of stdout
is {"ok": true, "device": {"platform", "kind", "count"}}.

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DETERMINISM_FLAG = "--xla_gpu_deterministic_ops=true"

# Tolerances, each with its reason:
# den/num log-probs and den posteriors vs fp32/fp64 references.
# Exact-mode chain math is fp32 class (chain/precision.py); two fp32
# evaluations of the 49-step recursion differ by summation order only, a
# few ulp per step.  A TF32 den misses the posterior bound (measured
# 2.4e-5 against the fp32 reference at flagship scale on the H100).
LOGPROB_RTOL = 2e-5
POST_ATOL = 1e-5
# numerator posteriors are exp(alpha + score + beta - total) of log-domain
# terms as large as the log-prob itself (~65 at T=49), so fp32 rounding
# of those sums gives an absolute posterior error proportional to
# |log-prob|: the bound is 1e-6 x max(1, |log-prob|), ~16 fp32 ulps of
# the log-prob (measured ~1.3e-5 at |lp| ~ 65 on the CPU).
NUM_POST_RTOL = 1e-6
# bf16 forward vs fp32 HIGHEST forward, on log-posteriors: bf16 keeps 8
# significant bits, and rounding errors add up through 27 layers; same
# bound as tests/test_network.py's bf16-vs-fp32 check.
FWD_REL_TOL = 0.15
# decoders: fp32 device path sums vs the host's float64 over T frames.
DECODE_RTOL = 1e-4
# data-parallel vs one card.  The first step's loss comes from the same
# parameters: bf16, the production dtype, flips some bf16 roundings with
# the per-shard conv/gemm algorithms (measured 1.3e-4 on four H100s); fp32
# only reorders sums (measured 7.7e-8).
DP_FIRST_STEP_RTOL = 2e-3
DP_F32_FIRST_STEP_RTOL = 1e-5
# The first step's gradient norm: a gradient that is mis-scaled or missing
# a shard moves it at first order; rounding noise, which is orthogonal to
# the gradient, at second order (measured 9.7e-6 fp32 on four H100s).
DP_GRAD_NORM_RTOL = 1e-4
# Past the first forward, the flagship's rounding noise is large: moving
# the parameters by 1e-7 relative (DP_NUDGE, about one fp32 ulp) on one
# card moves its chain derivative by 2e-6 but each leaf of its gradient by
# ~0.6%, so two equally right runs part after the first update (fp32 on
# an H100: 8 nudged runs spread by 5.8e-4 at step 2, 1.1e-2 at step 3).
# The update and the later losses are therefore held to that measured
# floor: data-parallel may be off one card by at most DP_NOISE_FACTOR
# times the largest deviation of DP_NUDGES nudged one-card runs, plus a
# margin far below what a wrong gradient exchange gives (an update half
# or twice its size is off by 50-100%; tests/test_chip_smoke.py).
DP_NUDGE = 1e-7
DP_NUDGES = 8
DP_NOISE_FACTOR = 2.0
DP_UPDATE_MARGIN = 1e-4
DP_F32_STEPS = 3
DP_BF16_STEPS = 8


@dataclasses.dataclass(frozen=True)
class Widths:
    xconfig: str = os.path.join(REPO, "configs", "cnn_tdnn.xconfig")
    pdfs: int = 3080
    den_phones: int = 3526          # x 2 states/phone = 7052-state den
    den_branching: int = 28         # ~113K arcs at 7052 states
    batch: int = 128
    frames_in: int = 150
    frames_out: int = 49
    num_arcs: int = 256
    oracle_batch: int = 2           # fp64 den oracle slice
    oracle_frames: int = 8
    epoch_batches: int = 2          # synthetic egs: batches per epoch
    warmup_steps: int = 1
    train_steps: int = 15           # 16 steps = 8 epochs
    repeat_steps: int = 3
    decode_states: int = 2048       # tools/decodebench.py defaults
    decode_pdfs: int = 512
    decode_arcs: int = 8
    decode_batch: int = 32
    decode_frames: int = 500
    decode_ref_utts: int = 3        # host reference: ~8 s per utterance


FLAGSHIP = Widths()


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailure(what)


def card_lines() -> list:
    """`name, power.limit` of each card, read by a child that is not JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()


def _rel_err(a, b):
    import numpy as np
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                        / np.maximum(1.0, np.abs(b))))


# ---------------------------------------------------------------------------
# den
# ---------------------------------------------------------------------------

def phase_den(w: Widths) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    from kaldi_fp16_tpu.chain.reference import (
        denominator_forward_backward_plain, denominator_forward_backward_ref,
    )

    graph = DenominatorGraph.from_fst(make_phone_lm_den_fst(
        num_pdfs=w.pdfs, num_phones=w.den_phones,
        branching=w.den_branching), w.pdfs)
    den = DenominatorComputation(graph, leaky=1e-5)
    check(den.layout_used == "structured",
          f"den layout {den.layout_used}, expected structured")
    rng = np.random.default_rng(0)
    out = (rng.normal(size=(w.batch, w.frames_out, w.pdfs)) * 0.5
           ).astype(np.float32)
    x = jnp.asarray(out)
    secs = {}
    t0 = time.perf_counter()
    lp, post = jax.block_until_ready(den.forward_backward(x))
    secs["first_call_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp2, post2 = jax.block_until_ready(den.forward_backward(x))
    secs["second_call_s"] = time.perf_counter() - t0
    repeat = (np.array_equal(np.asarray(lp), np.asarray(lp2))
              and np.array_equal(np.asarray(post), np.asarray(post2)))
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        ref_lp, ref_post = jax.jit(
            lambda o: denominator_forward_backward_plain(graph, o, 1e-5))(x)
    lp_err = _rel_err(lp, np.asarray(ref_lp))
    post_err = float(jnp.max(jnp.abs(post - ref_post)))
    secs["plain_reference_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n, t = w.oracle_batch, w.oracle_frames
    small = out[:n, :t]
    s_lp, s_post = den.forward_backward(jnp.asarray(small))
    o_lp = o_post = 0.0
    for b in range(n):
        rl, rp = denominator_forward_backward_ref(graph, small[b], 1e-5)
        o_lp = max(o_lp, abs(float(s_lp[b]) - rl) / max(1.0, abs(rl)))
        o_post = max(o_post, float(np.abs(np.asarray(s_post[b]) - rp).max()))
    secs["fp64_oracle_s"] = time.perf_counter() - t0
    res = {"states": graph.num_states, "arcs": graph.num_transitions,
           "N": w.batch, "T": w.frames_out, **secs,
           "logprob_rel_err_vs_fp32": lp_err,
           "post_abs_err_vs_fp32": post_err,
           "logprob_rel_err_vs_fp64": o_lp, "post_abs_err_vs_fp64": o_post,
           "repeat_bit_equal": repeat}
    check(bool(np.all(np.isfinite(np.asarray(lp)))), "den logprob not finite")
    check(lp_err <= LOGPROB_RTOL and o_lp <= LOGPROB_RTOL,
          f"den logprob off reference by > {LOGPROB_RTOL}: {res}")
    check(post_err <= POST_ATOL and o_post <= POST_ATOL,
          f"den posteriors off reference by > {POST_ATOL}: {res}")
    check(repeat, "den forward-backward repeat is not bit-equal")
    return res


# ---------------------------------------------------------------------------
# num
# ---------------------------------------------------------------------------

def _supervision_fsts(rng, n, frames, pdfs, arcs):
    """Linear supervision FSTs of `frames` steps with alternative pdf arcs
    per step, about `arcs` arcs each; the final state is reachable."""
    from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState
    per = max(1, arcs // frames)
    fsts = []
    for _ in range(n):
        states = [FstState() for _ in range(frames + 1)]
        for t in range(frames):
            for k in range(per):
                states[t].arcs.append(FstArc(
                    int(rng.integers(1, pdfs + 1)),
                    float(rng.uniform(0.0, 2.0)) if k else 0.0, t + 1))
        states[-1].final = 0.0
        fsts.append(Fst(start=0, states=states))
    return fsts


def phase_num(w: Widths) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from kaldi_fp16_tpu.chain.graph import build_numerator_batch
    from kaldi_fp16_tpu.chain.numerator import numerator_forward_backward
    from kaldi_fp16_tpu.chain.reference import numerator_forward_backward_ref
    from kaldi_fp16_tpu.io.sparse import fst_to_csr

    rng = np.random.default_rng(1)
    csrs = [fst_to_csr(f) for f in _supervision_fsts(
        rng, w.batch, w.frames_out, w.pdfs, w.num_arcs)]
    graph = build_numerator_batch(csrs, max_arcs=w.num_arcs)
    out = rng.normal(size=(w.batch, w.frames_out, w.pdfs)).astype(np.float32)
    lp, post = numerator_forward_backward(graph, jnp.asarray(out))
    lp, post = np.asarray(lp), np.asarray(post)
    lp_err = post_err = max_lp = 0.0
    for b in range(w.batch):
        rl, rp = numerator_forward_backward_ref(csrs[b], out[b])
        lp_err = max(lp_err, abs(float(lp[b]) - rl) / max(1.0, abs(rl)))
        post_err = max(post_err, float(np.abs(post[b] - rp).max()))
        max_lp = max(max_lp, abs(rl))
    post_tol = NUM_POST_RTOL * max(1.0, max_lp)
    res = {"B": w.batch, "A": graph.num_arcs, "S": graph.num_states,
           "max_abs_logprob": max_lp,
           "logprob_rel_err_vs_fp64": lp_err,
           "post_abs_err_vs_fp64": post_err, "post_tol": post_tol}
    check(lp_err <= LOGPROB_RTOL,
          f"num logprob off by > {LOGPROB_RTOL}: {res}")
    check(post_err <= post_tol, f"num posteriors off by > {post_tol}: {res}")
    return res


# ---------------------------------------------------------------------------
# fwd
# ---------------------------------------------------------------------------

def phase_fwd(w: Widths) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaldi_fp16_tpu.models.model import build_model
    from kaldi_fp16_tpu.models.network import forward, init_params

    model = build_model(w.xconfig)
    params, state = init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    feats = jnp.asarray(rng.normal(size=(w.batch, w.frames_in, 40))
                        .astype(np.float32))
    ivecs = jnp.asarray(rng.normal(size=(w.batch, 100)).astype(np.float32))

    def logpost(dtype):
        # train mode: batch-statistics batchnorm keeps every layer's
        # activations at scale (the init running stats would not)
        @jax.jit
        def f(params, feats, ivecs):
            outs, _ = forward(model, params, state, feats, ivecs,
                              train=True, rng=jax.random.PRNGKey(3),
                              compute_dtype=dtype)
            return jax.nn.log_softmax(
                outs["output-xent"].astype(jnp.float32), axis=-1)
        return np.asarray(f(params, feats, ivecs))

    low = logpost(jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        ref = logpost(jnp.float32)
    rel = float(np.max(np.abs(low - ref) / np.maximum(np.abs(ref), 1.0)))
    res = {"B": w.batch, "T": w.frames_in, "pdfs": ref.shape[-1],
           "logpost_max_rel_err": rel,
           "logpost_mean_abs_err": float(np.mean(np.abs(low - ref))),
           "argmax_agreement": float(np.mean(
               low.argmax(-1) == ref.argmax(-1)))}
    check(bool(np.all(np.isfinite(low))), "bf16 forward not finite")
    check(rel < FWD_REL_TOL, f"bf16 forward off fp32 by {rel} >= "
          f"{FWD_REL_TOL}")
    return res


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_egs(w: Widths, outdir: str) -> None:
    """Synthetic cegs arks + den.fst, written by tools/make_synthetic_egs.py
    in a child process pinned to the CPU."""
    n = w.batch * w.epoch_batches
    files = 2
    cmd = [sys.executable, os.path.join(REPO, "tools",
                                        "make_synthetic_egs.py"), outdir,
           "--files", str(files), "--per-file", str(-(-n // files)),
           "--pdfs", str(w.pdfs), "--frames-in", str(w.frames_in),
           "--frames-out", str(w.frames_out), "--den-topology", "phone-lm",
           "--den-states", str(2 * w.den_phones)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(cmd, check=True, env=env, capture_output=True,
                   text=True, timeout=900)


def _trainer(w: Widths, den, model, mesh=None, lr=1e-2, momentum=0.0,
             compute_dtype="bfloat16"):
    """Constant lr 0.01 (tools/traintest.py's), no momentum by default:
    a few epochs over the synthetic egs must improve the objective on
    them (with momentum 0.5 the flagship diverged within 10 steps on an
    H100)."""
    from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu.training.train_step import TrainConfig
    from kaldi_fp16_tpu.training.trainer import Trainer
    config = TrainConfig(learning_rate=lr, momentum=momentum,
                         frame_subsampling_factor=3,
                         compute_dtype=compute_dtype)
    return Trainer(model, den, config, ChainTrainingOpts(), seed=0,
                   mesh=mesh)


def _data_loader(w: Widths, egs: str):
    from kaldi_fp16_tpu.io.dataloader import DataLoader, DataLoaderConfig
    return DataLoader(egs, DataLoaderConfig(
        batch_size=w.batch, label_dim=w.pdfs,
        max_fst_states=256, max_fst_arcs=512))


def _epochs(w: Widths, egs: str):
    """tools/train.py's epoch loop: a fresh DataLoader over the egs per
    epoch, without end (the caller takes the steps it needs)."""
    while True:
        yield from _data_loader(w, egs)


def _den_from_egs(w: Widths, egs_dir: str):
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.graph import DenominatorGraph
    from kaldi_fp16_tpu.io.fst import read_fst_file
    graph = DenominatorGraph.from_fst(
        read_fst_file(os.path.join(egs_dir, "den.fst")), w.pdfs)
    return DenominatorComputation(graph, leaky=1e-5)


def _run_steps(trainer, batches, n, timed=False):
    """tools/train.py's pipelined loop: batch i+1 uploads while step i
    runs.  Returns per-step (loss, objf/frame, num_logprob, grad_norm)
    and, when `timed`, per-step wall seconds (each step waited for)."""
    import jax
    rows, secs = [], []
    it = iter(batches)
    nxt = next(it, None)
    placed = trainer.place_batch(nxt) if nxt is not None else None
    while nxt is not None and len(rows) < n:
        batch, cur = nxt, placed
        nxt = next(it, None)
        t0 = time.perf_counter()
        out = trainer.train_batch(batch, placed=cur)
        placed = trainer.place_batch(nxt) if nxt is not None else None
        if timed:
            jax.block_until_ready(out.loss)
            secs.append(time.perf_counter() - t0)
        rows.append(out)
    vals = jax.device_get([(o.loss, o.objf_per_frame, o.num_logprob,
                            o.grad_norm) for o in rows])
    return [tuple(float(v) for v in r) for r in vals], secs


def _cache_counter():
    import jax
    counts = {"/jax/compilation_cache/cache_hits": 0,
              "/jax/compilation_cache/cache_misses": 0}

    def listen(event, **kwargs):
        if event in counts:
            counts[event] += 1
    jax.monitoring.register_event_listener(listen)
    return counts


def _loader_workers_stay_off_card(w: Widths, egs: str) -> int:
    """ProcessLoader workers import the package (and jax) while this
    process holds the card.  A worker that initialised a backend there
    would fail to reserve memory, so batches arriving prove they did not."""
    from kaldi_fp16_tpu.io.dataloader import DataLoaderConfig, ProcessLoader
    cfg = DataLoaderConfig(batch_size=w.batch, label_dim=w.pdfs,
                           max_fst_states=256, max_fst_arcs=512)
    loader = ProcessLoader(egs, cfg, workers=2, depth=1)
    try:
        got = 0
        for _ in loader:
            got += 1
            if got == 2:
                break
    finally:
        loader.close()
    return got


def phase_train(w: Widths, workdir: str) -> dict:
    import jax
    import numpy as np
    from kaldi_fp16_tpu.models.model import build_model

    t0 = time.perf_counter()
    make_egs(w, workdir)
    gen_s = time.perf_counter() - t0
    egs = os.path.join(workdir, "cegs.*.ark")
    model = build_model(w.xconfig)
    den = _den_from_egs(w, workdir)
    check(den.layout_used == "structured", "flagship den not structured")
    counts = _cache_counter()
    trainer = _trainer(w, den, model)
    steps = w.warmup_steps + w.train_steps
    rows, secs = _run_steps(trainer, _epochs(w, egs), steps, timed=True)
    check(len(rows) == steps, f"only {len(rows)} of {steps} batches")
    step_s = statistics.median(secs[w.warmup_steps:])

    # the step's compiled program (persistent cache hit when enabled)
    first = next(iter(_data_loader(w, egs)))
    compiled = trainer.lower_step(first).compile()
    mem = compiled.memory_analysis()
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")

    # repeat from the same seed: the losses must be bit-equal
    again = _trainer(w, den, model)
    rep, _ = _run_steps(again, _epochs(w, egs), w.repeat_steps)
    repeat_equal = rep == rows[:w.repeat_steps]
    workers_batches = _loader_workers_stay_off_card(w, egs)

    losses = [r[0] for r in rows]
    objf = [r[1] for r in rows]
    # halves of the run: single steps swing by up to ~0.1 nats/frame
    # with the SpecAugment masks, a half's mean by far less
    half = len(objf) // 2
    first_half, second_half = np.mean(objf[:half]), np.mean(objf[half:])
    res = {"B": w.batch, "T_in": w.frames_in, "T_out": w.frames_out,
           "pdfs": w.pdfs, "den_states": den.graph.num_states,
           "den_arcs": den.graph.num_transitions, "steps": len(rows),
           "egs_gen_s": gen_s,
           "first_step_s": secs[0], "median_step_ms": step_s * 1e3,
           "step_ms": [s * 1e3 for s in secs],
           "losses": losses, "objf_per_frame": [r[1] for r in rows],
           "num_logprob": [r[2] for r in rows],
           "objf_first_half": first_half, "objf_second_half": second_half,
           "memory_analysis": str(mem), "peak_bytes_in_use": peak,
           "compile_cache": {k.rsplit("/", 1)[-1]: v
                             for k, v in counts.items()},
           "repeat_bit_equal": repeat_equal,
           "process_loader_batches": workers_batches}
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(all(r[2] > -1e20 for r in rows),
          "numerator hit the containment fallback")
    check(second_half > first_half,
          f"objective got worse over the steps: {objf}")
    check(repeat_equal, f"same-seed repeat differs: {rep} vs "
          f"{rows[:w.repeat_steps]}")
    check(workers_batches == 2, "ProcessLoader delivered no batches")
    return res


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def phase_decode(w: Widths) -> dict:
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from decodebench import synth_graph
    from kaldi_fp16_tpu.decode.graph import DecodingGraph
    from kaldi_fp16_tpu.decode.tpu_viterbi import (
        DeviceLatticeDecoder, SparseViterbiDecoder,
    )
    from kaldi_fp16_tpu.decode.viterbi import DecodeOptions, ViterbiDecoder

    graph = DecodingGraph.from_fst(
        synth_graph(w.decode_states, w.decode_pdfs, w.decode_arcs))
    rng = np.random.default_rng(1)
    ll = rng.normal(size=(w.decode_batch, w.decode_frames,
                          w.decode_pdfs)).astype(np.float32)
    host = ViterbiDecoder(graph, DecodeOptions(beam=1e9, max_active=10 ** 9))
    refs = [host.decode(ll[b]) for b in range(w.decode_ref_utts)]
    res = {"states": graph.num_states, "B": w.decode_batch,
           "T": w.decode_frames, "ref_utts": len(refs)}

    def compare(name, words, costs):
        err = max(abs(c - r.total_cost) / max(1.0, abs(r.total_cost))
                  for c, r in zip(costs, refs))
        same = all(wd == r.words for wd, r in zip(words, refs))
        res[name] = {"words_equal": same, "cost_rel_err": err}
        check(same, f"{name}: best-path words differ from the host decoder")
        check(err <= DECODE_RTOL, f"{name}: cost off by {err}")

    for layout in ("segment", "tree"):
        dec = SparseViterbiDecoder(graph, acoustic_scale=1.0, layout=layout)
        out = dec.decode_batch(ll)
        check(all(r["final_reached"] for r in out),
              f"{layout}: final not reached")
        compare(f"viterbi_{layout}", [r["words"] for r in out],
                [r["total_cost"] for r in out])
        check(all(out[b]["alignment"] == refs[b].alignment
                  for b in range(len(refs))),
              f"{layout}: alignment differs from the host decoder")
    lats = DeviceLatticeDecoder(graph, acoustic_scale=1.0).decode_batch(ll)
    best = [lat.best_path() for lat in lats]
    compare("lattice", [b[0] for b in best], [b[1] for b in best])
    return res


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _nudged(params, seed: int):
    """`params` moved by DP_NUDGE relative, elementwise, from `seed`."""
    import jax
    leaves, tdef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        x * (1 + DP_NUDGE * jax.random.normal(k, x.shape, x.dtype))
        for x, k in zip(leaves, keys)])


def _trajectory(w: Widths, trainer, egs: str, steps: int):
    """`steps` of _run_steps over the egs epochs, and each parameter
    leaf's change in the first step (float64, flattened order)."""
    import itertools
    import jax
    import numpy as np
    before = jax.device_get(jax.tree_util.tree_leaves(trainer.params))
    batches = _epochs(w, egs)
    rows, secs = _run_steps(trainer, itertools.islice(batches, 1), 1,
                            timed=True)
    after = jax.device_get(jax.tree_util.tree_leaves(trainer.params))
    update = [np.asarray(a, np.float64) - b for a, b in zip(after, before)]
    more, more_secs = _run_steps(trainer, batches, steps - 1, timed=True)
    return rows + more, secs + more_secs, update


def _leaf_rel(ref, other):
    import numpy as np
    return [float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))
            for a, b in zip(ref, other)]


def phase_data_parallel(w: Widths, workdir: str, n_dev: int = 4) -> dict:
    """Flagship steps at global batch w.batch over make_mesh(data=n_dev)
    vs one card from the same seed on the same batches, in fp32 (the
    arbiter of the gradient exchange) and bf16 (the production dtype).
    DP_NUDGES one-card runs from nudged parameters measure the rounding
    noise floor the comparison is held to (see DP_NUDGE)."""
    import jax
    import numpy as np
    from kaldi_fp16_tpu.models.model import build_model
    from kaldi_fp16_tpu.parallel.mesh import MeshConfig, make_mesh

    check(len(jax.devices()) >= n_dev,
          f"needs {n_dev} devices, JAX has {len(jax.devices())}")
    make_egs(w, workdir)
    egs = os.path.join(workdir, "cegs.*.ark")
    model = build_model(w.xconfig)
    den = _den_from_egs(w, workdir)
    mesh = make_mesh(MeshConfig(data=n_dev))
    res = {"devices": n_dev, "mesh": dict(mesh.shape),
           "global_batch": w.batch,
           "collectives": f"XLA all-reduce on {jax.devices()[0].platform}"}
    dp_trainer = None
    for dtype, steps in (("float32", DP_F32_STEPS),
                         ("bfloat16", DP_BF16_STEPS)):
        runs = {}
        one = None
        for name, m, nudge in (
                [("one_card", None, None), ("data_parallel", mesh, None)]
                + [(f"nudged{s}", None, s) for s in range(DP_NUDGES)]):
            # tools/train.py's default lr, no momentum
            trainer = _trainer(w, den, model, mesh=m, lr=1e-3,
                               compute_dtype=dtype)
            if nudge is not None:
                trainer.params = _nudged(trainer.params, nudge)
                trainer._steps = one._steps     # the one-card programs
            rows, secs, update = _trajectory(w, trainer, egs, steps)
            check(len(rows) == steps, f"{name} {dtype}: missing steps")
            check(all(np.isfinite(r[0]) and r[2] > -1e20 for r in rows),
                  f"{name} {dtype}: non-finite loss or containment")
            runs[name] = (rows, update)
            if name == "one_card":
                one = trainer
            if nudge is None:
                res[f"{dtype}_{name}_first_step_s"] = secs[0]
                res[f"{dtype}_{name}_median_step_ms"] = statistics.median(
                    secs[1:]) * 1e3
            if m is not None:
                dp_trainer = trainer
        ref_rows, ref_update = runs["one_card"]

        def loss_dev(name):
            return [abs(r[0] - q[0]) / max(1.0, abs(q[0]))
                    for r, q in zip(runs[name][0], ref_rows)]

        nudged = [n for n in runs if n.startswith("nudged")]
        dp_dev = loss_dev("data_parallel")
        noise_dev = [max(d) for d in zip(*(loss_dev(n) for n in nudged))]

        def grad_norm_dev(name):
            gn = runs[name][0][0][3]
            return abs(gn - ref_rows[0][3]) / ref_rows[0][3]

        dp_leaf = _leaf_rel(ref_update, runs["data_parallel"][1])
        noise_leaf = [_leaf_rel(ref_update, runs[n][1]) for n in nudged]
        res[dtype] = {
            "losses": {n: [r[0] for r in rows]
                       for n, (rows, _) in runs.items()},
            "first_step_rel_diff": dp_dev[0],
            "first_grad_norm_rel_diff": grad_norm_dev("data_parallel"),
            "noise_first_grad_norm_rel_diff": max(
                grad_norm_dev(n) for n in nudged),
            "loss_rel_diff": dp_dev, "noise_loss_rel_diff": noise_dev,
            "max_loss_rel_diff": max(dp_dev),
            "update_leaf_rel_median": float(np.median(dp_leaf)),
            "update_leaf_rel_max": max(dp_leaf),
            "noise_update_leaf_rel_median": max(
                float(np.median(x)) for x in noise_leaf),
            "noise_update_leaf_rel_max": max(max(x) for x in noise_leaf)}
    first = next(iter(_data_loader(w, egs)))
    hlo = dp_trainer.lower_step(first).compile().as_text()
    res["all_reduce_ops_in_step"] = (hlo.count("all-reduce-start")
                                     + hlo.count(" all-reduce("))

    def within(r, key, margin):
        """r[key] <= the nudged runs' floor (DP_NOISE_FACTOR) + margin."""
        return r[key] <= DP_NOISE_FACTOR * r["noise_" + key] + margin

    # both dtypes: the first step's loss and gradient norm; fp32 also the
    # first update leaf by leaf and the losses of every step (bf16's later
    # steps part within a few steps on one card alone: reported only)
    f32 = res["float32"]
    for dtype, rtol in (("float32", DP_F32_FIRST_STEP_RTOL),
                        ("bfloat16", DP_FIRST_STEP_RTOL)):
        r = res[dtype]
        check(r["first_step_rel_diff"] <= rtol,
              f"{dtype} dp first-step loss off one card: {res}")
        check(within(r, "first_grad_norm_rel_diff", DP_GRAD_NORM_RTOL),
              f"{dtype} dp gradient norm off one card: {res}")
    for key in ("update_leaf_rel_median", "update_leaf_rel_max"):
        check(within(f32, key, DP_UPDATE_MARGIN),
              f"fp32 dp first update off one card beyond the noise: {res}")
    check(all(d <= DP_NOISE_FACTOR * n + DP_F32_FIRST_STEP_RTOL
              for d, n in zip(f32["loss_rel_diff"],
                              f32["noise_loss_rel_diff"])),
          f"fp32 dp losses off one card beyond the noise: {res}")
    check(res["all_reduce_ops_in_step"] > 0,
          "no all-reduce in the data-parallel step")
    return res


# ---------------------------------------------------------------------------

def _report(card: str, name: str, res: dict) -> None:
    log(f"[{card}] {name}: " + json.dumps(res, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-parallel training path over "
                         "four cards and its one-card comparison")
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if DETERMINISM_FLAG not in flags:
        os.environ["XLA_FLAGS"] = (flags + " " + DETERMINISM_FLAG).strip()
    from kaldi_fp16_tpu.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform}); refusing to run", file=sys.stderr)
        return 2
    # the native cegs parser the data loader uses, built from cpp/
    subprocess.run(["make", "-C", os.path.join(REPO, "cpp")], check=True,
                   capture_output=True, timeout=300)
    cards = card_lines()
    for line in cards:
        log(line)
    card = cards[0]
    log(f"jax {jax.__version__}; devices {len(devices)} x "
        f"{devices[0].device_kind}; XLA_FLAGS={os.environ['XLA_FLAGS']}; "
        f"compile cache {cache_dir}")

    with tempfile.TemporaryDirectory() as work:
        if args.four_cards:
            t0 = time.perf_counter()
            _report(card, "data_parallel",
                    phase_data_parallel(FLAGSHIP, work))
            log(f"data_parallel: {time.perf_counter() - t0:.1f} s")
        else:
            # train first: its peak_bytes_in_use is then the step's own
            phases = [("train", lambda: phase_train(FLAGSHIP, work)),
                      ("den", lambda: phase_den(FLAGSHIP)),
                      ("num", lambda: phase_num(FLAGSHIP)),
                      ("fwd", lambda: phase_fwd(FLAGSHIP)),
                      ("decode", lambda: phase_decode(FLAGSHIP))]
            for name, run in phases:
                t0 = time.perf_counter()
                res = run()
                _report(card, name, res)
                if name == "train":
                    # the first step traces the program and compiles it,
                    # or loads it when the persistent compile cache has it
                    # (the hit and miss counts tell which)
                    for key in ("first_step_s", "compile_cache",
                                "median_step_ms", "memory_analysis",
                                "peak_bytes_in_use"):
                        log(f"[{card}] train {key}: {res[key]}")
                log(f"{name}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
