#!/usr/bin/env python
"""gputest — data pipeline -> device transfer benchmark (ref:
cmd/gputest/main.go: parse ms, transfer ms, MB, fp16 round-trip error).

The reference measured CGO pinned-memory PCIe uploads; the analog here is
host parse time, device_put throughput over PCIe, and the
bf16/fp16 conversion audit (conversion loss on real feature ranges).

Usage: python tools/gputest.py [--egs PATTERN] [--batch 8] [--iters 10]
"""

import argparse
import subprocess
import sys
import tempfile
import time

import _common  # noqa: F401
import numpy as np


def main():
    _common.enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--egs")
    ap.add_argument("--pdfs", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mb", type=float, default=64.0,
                    help="payload size for the raw transfer benchmark")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from kaldi_fp16_tpu.io.dataloader import DataLoader, DataLoaderConfig
    from kaldi_fp16_tpu.utils.lowp import analyze_conversion

    if not args.egs:
        tmp = tempfile.mkdtemp(prefix="gputest_")
        subprocess.run([sys.executable, "tools/make_synthetic_egs.py", tmp,
                        "--pdfs", str(args.pdfs)], check=True)
        args.egs = f"{tmp}/cegs.*.ark"

    # 1. parse throughput
    t0 = time.perf_counter()
    dl = DataLoader(args.egs, DataLoaderConfig(batch_size=args.batch,
                                               label_dim=args.pdfs))
    batches = list(dl)
    parse_s = time.perf_counter() - t0
    n_ex = dl.stats.examples_read
    print(f"parse: {n_ex} examples -> {len(batches)} batches "
          f"in {parse_s*1e3:.1f} ms ({n_ex/max(parse_s,1e-9):.0f} ex/s)")
    if not batches:
        sys.exit("error: no batches")

    # 2. batch transfer (features + ivectors + FST arrays, like the
    #    reference's packed single-copy GPUBatch)
    b = batches[0]
    arrays = [b.features, b.ivectors, b.num_graph.arc_src, b.num_graph.arc_dst,
              b.num_graph.arc_pdf, b.num_graph.arc_logw, b.num_graph.arc_mask,
              b.num_graph.final_logw]
    arrays = [a for a in arrays if a is not None]
    nbytes = sum(a.nbytes for a in arrays)
    for _ in range(2):  # warm up
        out = [jax.device_put(a) for a in arrays]
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = [jax.device_put(a) for a in arrays]
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / args.iters
    print(f"batch transfer: {nbytes/1e6:.2f} MB in {dt*1e3:.2f} ms "
          f"({nbytes/dt/1e9:.2f} GB/s)")

    # 3. raw large-payload transfer (bandwidth ceiling)
    big = np.random.default_rng(0).random(
        (int(args.mb * 1e6 / 4),), np.float32)
    jax.block_until_ready(jax.device_put(big))
    t0 = time.perf_counter()
    for _ in range(3):
        jax.block_until_ready(jax.device_put(big))
    dt = (time.perf_counter() - t0) / 3
    print(f"raw transfer: {big.nbytes/1e6:.0f} MB in {dt*1e3:.1f} ms "
          f"({big.nbytes/dt/1e9:.2f} GB/s)")

    # 4. low-precision round-trip audit on the real features
    feats = np.concatenate([bb.features.reshape(-1) for bb in batches[:4]])
    for fmt in ("float16", "bfloat16"):
        st = analyze_conversion(feats, fmt=fmt)
        print(f"{fmt} round-trip: max_abs_err={st.max_abs_err:.3e} "
              f"avg_abs_err={st.avg_abs_err:.3e} overflow={st.overflow} "
              f"underflow={st.underflow}")

    # 5. device round-trip exactness for bf16 upload (what training uses)
    x = jnp.asarray(feats[:1 << 16])
    back = np.asarray(jax.device_get(x))
    ok = np.array_equal(back, feats[:1 << 16])
    print(f"fp32 device round-trip bit-exact: {ok}")
    print("PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
