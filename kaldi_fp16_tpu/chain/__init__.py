"""LF-MMI "chain" objective: numerator/denominator forward-backward.

Redesign of the reference chain stack
(ref: internal/nnet/{chain_loss,denominator,backward}.go,
cpp/cuda/{chain,chain_den,chain_backward,chain_det}.cu):

  graph.py        denominator HMM graph + padded numerator FST batches
  reference.py    numpy float64 oracles (the correctness anchor; the
                  reference used real Kaldi as its oracle — without Kaldi on
                  this machine, the fp64 oracle + brute-force path
                  enumeration + finite differences play that role)
  numerator.py    log-domain forward-backward as a jitted lax.scan
  denominator.py  probability-domain leaky-HMM forward-backward (lax.scan)
  objective.py    ComputeChainObjfAndDeriv equivalent with jax.custom_vjp
"""

from kaldi_fp16_tpu.chain.graph import DenominatorGraph, NumeratorGraphBatch, build_numerator_batch
from kaldi_fp16_tpu.chain.objective import ChainTrainingOpts, ChainResult, chain_loss_and_grad, chain_objf
