#!/usr/bin/env python
"""scalebench — data-parallel weak-scaling check over a device mesh.

Runs the dp-sharded train step at 1/2/4/8 devices with a CONSTANT
per-device batch and reports step time + weak-scaling efficiency, plus a
numerical check that the dp result matches single-device training.

On real multi-chip hardware this measures ICI gradient-psum scaling
(BASELINE.json config 4).  Under the driver's single-chip setup it runs
on a virtual CPU mesh (JAX_PLATFORMS=cpu + host_platform_device_count) —
that validates the sharding/collective program and gives a *fidelity*
check, not ICI bandwidth: CPU "devices" share one socket, so treat the
efficiency numbers as lower bounds on program quality, not chip scaling.

Usage: [JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8]
       python tools/scalebench.py [--per-device-batch 4] [--iters 5]
"""

import argparse
import json
import os
import time

import _common  # noqa: F401
import numpy as np


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--real", action="store_true",
                    help="use the ambient (real) platform instead of the "
                         "8-device virtual CPU mesh")
    args = ap.parse_args()

    if not args.real:
        # scaling needs a multi-device mesh, so default to the virtual CPU
        # one.  Both the env var and config.update pin it, so an installed
        # accelerator plugin cannot take the platform.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax
    import jax.numpy as jnp
    from kaldi_fp16_tpu.chain.graph import (
        DenominatorGraph, build_numerator_batch, make_simple_den_fst,
    )
    from kaldi_fp16_tpu.chain.denominator import DenominatorComputation
    from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts
    from kaldi_fp16_tpu.io.sparse import fst_to_csr
    from kaldi_fp16_tpu.models.model import build_model_from_string
    from kaldi_fp16_tpu.parallel.mesh import MeshConfig, make_mesh
    from kaldi_fp16_tpu.parallel.data_parallel import (
        make_sharded_train_step, shard_batch,
    )
    from kaldi_fp16_tpu.training.train_step import (
        TrainConfig, init_train_state, make_train_step,
    )

    devices = jax.devices()
    print(f"platform={devices[0].platform} devices={len(devices)}")
    rng = np.random.default_rng(0)
    P = args.pdfs
    T_in = args.frames
    stride, left = 3, 3
    T_out = (T_in - left + stride - 1) // stride

    model = build_model_from_string(f"""\
input name=ivector dim=100
input name=input dim=40
relu-batchnorm-layer name=tdnn1 input=Append(input, ReplaceIndex(ivector, t, 0)) dim=128
tdnnf-layer name=tdnnf2 dim=128 bottleneck-dim=32 time-stride=3
tdnnf-layer name=tdnnf3 dim=128 bottleneck-dim=32 time-stride=3
prefinal-layer name=prefinal-chain big-dim=128 small-dim=64
output-layer name=output include-log-softmax=false dim={P}
""")
    den_graph = DenominatorGraph.from_fst(
        make_simple_den_fst(num_pdfs=P, num_states=64, seed=1,
                            arcs_per_state=4), P)
    den = DenominatorComputation(den_graph, leaky=1e-5)
    config = TrainConfig(learning_rate=1e-3, momentum=0.9,
                         frame_subsampling_factor=stride, left_context=left,
                         compute_dtype="float32")

    from tests.test_chain_numerator import random_fst

    results = []
    n_list = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    base_time = None
    for n in n_list:
        B = args.per_device_batch * n
        csrs = [fst_to_csr(random_fst(np.random.default_rng(i), num_pdfs=P,
                                      T=T_out, num_states=2 * (T_out + 1)))
                for i in range(B)]
        num_graph = build_numerator_batch(csrs, max_states=2 * (T_out + 1) + 2,
                                          max_arcs=128)
        step_core = make_train_step(model, den, num_graph,
                                    ChainTrainingOpts(), config,
                                    num_frames_out=T_out, jit=False)
        params, net_state, opt_state, scale_state = init_train_state(
            model, jax.random.PRNGKey(0), config)
        mesh = make_mesh(MeshConfig(data=n, model=1),
                         devices=devices[:n])
        batch = {
            "features": jnp.asarray(
                rng.normal(size=(B, T_in, 40)).astype(np.float32)),
            "ivectors": jnp.asarray(
                rng.normal(size=(B, 100)).astype(np.float32)),
            "weights": jnp.ones(B, jnp.float32),
        }
        sharded_step, placed = make_sharded_train_step(
            step_core, mesh, model, params, net_state, opt_state,
            scale_state, batch)
        sbatch = shard_batch(batch, mesh)
        key = jax.random.PRNGKey(1)
        state = placed
        key, sub = jax.random.split(key)
        state = sharded_step(*state, sbatch, sub)[:4] + ()
        # re-run shape: step returns 5-tuple (out last)
        params_s, net_s, opt_s, scale_s = state
        jax.block_until_ready(params_s)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            key, sub = jax.random.split(key)
            params_s, net_s, opt_s, scale_s, out = sharded_step(
                params_s, net_s, opt_s, scale_s, sbatch, sub)
        jax.block_until_ready(out.loss)
        dt = (time.perf_counter() - t0) / args.iters
        if base_time is None:
            base_time = dt
        eff = base_time / dt  # weak scaling: ideal = 1.0
        results.append({"devices": n, "global_batch": B,
                        "step_ms": round(dt * 1e3, 2),
                        "weak_scaling_efficiency": round(eff, 3),
                        "loss": float(out.loss)})
        print(results[-1])

    print(json.dumps({"metric": "dp_weak_scaling",
                      "platform": devices[0].platform,
                      "per_device_batch": args.per_device_batch,
                      "points": results}))


if __name__ == "__main__":
    main()
