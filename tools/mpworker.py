#!/usr/bin/env python
"""Multi-process distributed training worker (SURVEY §2.7 strategy).

One OS process of an N-process jax.distributed job on CPU devices.  Used
by tests/test_multiprocess.py (which launches N of these and checks the
sharded losses against a single-process run) and by
__graft_entry__.dryrun_multichip's multi-process phase.

Exercises the full multi-host pattern:
  jax.distributed.initialize  ->  global mesh over all processes'
  devices  ->  per-process ark-file sharding (shard_files)  ->  global
  batch assembly from process-local shards
  (jax.make_array_from_process_local_data)  ->  jit train steps with
  data-axis shardings (grad psum over DCN in production)  ->  checkpoint
  save under the multi-process mesh + restore + verification.
"""

import argparse
import glob as globlib
import json
import os
import sys

# CPU platform with 2 local devices per process, BEFORE importing jax.
# Hard assignment, not setdefault: this worker is defined to run on CPU
# whatever the ambient platform.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2").strip()

import jax                                            # noqa: E402
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp                               # noqa: E402
import numpy as np                                    # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--egs", required=True, help="ark glob, shared by all")
    ap.add_argument("--out", required=True, help="result JSON path")
    ap.add_argument("--ckpt", required=True, help="checkpoint dir (shared)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--heartbeat", type=int, default=None,
                    help="peer-death detection timeout (s); lower it for "
                         "fail-fast tests")
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="SIGKILL self before this step completes "
                         "(failure-containment tests: survivors must "
                         "error out, not hang)")
    ap.add_argument("--restore-step", type=int, default=None,
                    help="elastic resume: restore this checkpoint step "
                         "(possibly written under a DIFFERENT process "
                         "count) before training")
    args = ap.parse_args()

    from kaldi_fp16_tpu.parallel.mesh import initialize_distributed, make_mesh
    initialize_distributed(args.coordinator, args.nproc, args.pid,
                           heartbeat_timeout_seconds=args.heartbeat)
    assert jax.process_count() == args.nproc, jax.process_count()
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == args.nproc * n_local

    from kaldi_fp16_tpu.io.dataloader import shard_files
    from kaldi_fp16_tpu.io.egs import read_examples
    from kaldi_fp16_tpu.io.sparse import fst_to_csr
    from kaldi_fp16_tpu.chain.graph import (
        DenominatorGraph, build_numerator_batch, make_simple_den_fst,
    )
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu.models.model import build_model_from_string
    from kaldi_fp16_tpu.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )
    from tests.test_multiprocess import (
        MP_XCONFIG, NUM_PDFS, FST_PAD_STATES, FST_PAD_ARCS, STRIDE, T_OUT,
    )

    # --- per-process input shard -> local batch arrays --------------------
    files = sorted(globlib.glob(args.egs))
    local_files = shard_files(files, args.pid, args.nproc)
    exs = []
    for f in local_files:
        exs.extend(read_examples(f))
    exs = exs[:args.local_batch]
    assert len(exs) == args.local_batch, (len(exs), local_files)

    feats_local = np.stack([e.features for e in exs]).astype(np.float32)
    weights_local = np.asarray([e.supervision.weight for e in exs],
                               np.float32)
    csrs = [fst_to_csr(e.supervision.fst) for e in exs]
    g_local = build_numerator_batch(csrs, max_states=FST_PAD_STATES,
                                    max_arcs=FST_PAD_ARCS)

    # --- global mesh + global arrays from process-local shards ------------
    mesh = make_mesh()          # data axis spans every device of every proc
    d_sh = NamedSharding(mesh, P("data"))
    r_sh = NamedSharding(mesh, P())

    def globalize(a):
        return jax.make_array_from_process_local_data(d_sh, a)

    batch = {"features": globalize(feats_local),
             "weights": globalize(weights_local)}
    graph_arrays = [globalize(np.asarray(a)) for a in (
        g_local.arc_src, g_local.arc_dst, g_local.arc_pdf, g_local.arc_logw,
        g_local.arc_mask, g_local.start, g_local.final_logw)]

    # --- model + sharded step --------------------------------------------
    model = build_model_from_string(MP_XCONFIG)
    den_graph = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=NUM_PDFS, num_states=5, seed=9),
        NUM_PDFS)
    den = DenominatorComputation(den_graph, leaky=1e-4)
    config = TrainConfig(learning_rate=0.01, momentum=0.5,
                         frame_subsampling_factor=STRIDE,
                         compute_dtype="float32")
    pure = make_train_step(model, den, None, ChainTrainingOpts(), config,
                           num_frames_out=T_OUT, donate=False, jit=False,
                           graph_in_args=True)
    params, net_state, opt_state, scale_state = init_train_state(
        model, jax.random.PRNGKey(0), config)

    repl_tree = jax.tree_util.tree_map(lambda _: r_sh, (
        params, net_state, opt_state, scale_state))
    params, net_state, opt_state, scale_state = jax.device_put(
        (params, net_state, opt_state, scale_state), repl_tree)

    step = jax.jit(
        pure,
        in_shardings=(repl_tree[0], repl_tree[1], repl_tree[2],
                      repl_tree[3], {k: d_sh for k in batch},
                      d_sh, d_sh, d_sh, d_sh, d_sh, d_sh, d_sh,
                      r_sh, r_sh, r_sh),
        out_shardings=(repl_tree[0], repl_tree[1], repl_tree[2],
                       repl_tree[3], r_sh),
    )

    from kaldi_fp16_tpu.training.checkpoint import (
        CheckpointManager, DataPosition,
    )

    # --- elastic resume: restore a checkpoint possibly written under a
    # DIFFERENT process count.  Replicated state restores cleanly onto
    # the current (bigger or smaller) mesh because the tensorstore files
    # hold the full arrays; re-placement commits them to this session's
    # shardings (same rule as Trainer.restore -> place_states).
    restored_param_sums = None
    if args.restore_step is not None:
        mgr0 = CheckpointManager(args.ckpt)
        (params, net_state, opt_state, scale_state, _gs, _pos) = \
            mgr0.restore(args.restore_step, params, net_state, opt_state,
                         scale_state)
        params, net_state, opt_state, scale_state = jax.device_put(
            (params, net_state, opt_state, scale_state), repl_tree)
        restored_param_sums = [
            float(np.asarray(x, np.float64).sum())
            for x in jax.tree_util.tree_leaves(params)]

    losses = []
    rng = jax.random.PRNGKey(5)
    lr = jnp.asarray(config.learning_rate, jnp.float32)
    lc = jnp.asarray(0, jnp.int32)
    for i in range(args.steps):
        if args.die_at_step is not None and i == args.die_at_step:
            import signal
            os.kill(os.getpid(), signal.SIGKILL)   # simulated hard crash
        params, net_state, opt_state, scale_state, out = step(
            params, net_state, opt_state, scale_state, batch,
            *graph_arrays, rng, lr, lc)
        losses.append(float(out.loss))

    # --- checkpoint under the multi-process mesh --------------------------
    ckpt_ok = False
    try:
        # orbax save/restore are COLLECTIVE in a multi-process session:
        # every process participates (process 0 writes the metadata, each
        # process its addressable shards) — a pid-0-only save deadlocks
        save_step = args.steps + (args.restore_step or 0)
        mgr = CheckpointManager(args.ckpt)
        mgr.save(save_step, params, net_state, opt_state, scale_state,
                 DataPosition(epoch=1, batches_consumed=save_step))
        (p2, _ns2, _os2, _ss2, _st, pos2) = mgr.restore(
            save_step, params, net_state, opt_state, scale_state)
        flat1 = jax.tree_util.tree_leaves(params)
        flat2 = jax.tree_util.tree_leaves(p2)
        ckpt_ok = all(
            np.allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
            for a, b in zip(flat1, flat2))
        ckpt_ok = ckpt_ok and pos2.batches_consumed == save_step
    except Exception as e:  # report, don't crash the loss comparison
        print(f"checkpoint phase failed: {e}", file=sys.stderr)

    param_sums = [float(np.asarray(x, np.float64).sum())
                  for x in jax.tree_util.tree_leaves(params)]
    with open(args.out, "w") as f:
        json.dump({"pid": args.pid,
                   "process_count": jax.process_count(),
                   "global_devices": n_global,
                   "local_files": [os.path.basename(x) for x in local_files],
                   "losses": losses,
                   "param_sums": param_sums,
                   "restored_param_sums": restored_param_sums,
                   "ckpt_ok": bool(ckpt_ok)}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
