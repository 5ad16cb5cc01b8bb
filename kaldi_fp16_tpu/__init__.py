"""kaldi_fp16_tpu — Kaldi-chain acoustic training & inference in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of
djeday123/kaldi-fp16 (hybrid-ASR LF-MMI "chain" training): Kaldi cegs data
pipeline, CNN-TDNN(-F) acoustic models, log-domain numerator and leaky-HMM
denominator forward-backward, mixed-precision SGD, data-parallel scaling over
device meshes, and WFST decoding.

Layer map (mirrors the reference's layers, SURVEY.md §1, redesigned for XLA):
  io/        cegs/FST parsing + batching   (ref: internal/parser, sparse, batch, loader)
  chain/     LF-MMI objective              (ref: internal/nnet chain_*, cpp/cuda/chain*.cu)
  models/    xconfig -> network            (ref: internal/nnet xconfig/layers/model/forward)
  ops/       NN blocks                     (ref: cpp/cuda/*.cu)
  training/  optimizer, train step, ckpt   (ref: internal/gpu/optimize.go, train_step.go)
  parallel/  mesh + shardings              (new: reference is single-GPU)
  decode/    WFST Viterbi decoding         (new: reference has none)
"""

__version__ = "0.1.0"
