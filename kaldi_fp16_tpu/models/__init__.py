"""Acoustic model layer: xconfig DSL -> layer specs -> JAX network.

Redesign of the reference model stack
(ref: internal/nnet/{xconfig,layers,model,forward}.go).
"""

from kaldi_fp16_tpu.models.xconfig import parse_xconfig, parse_xconfig_file, LayerConfig
from kaldi_fp16_tpu.models.layers import resolve_layers, Layer
from kaldi_fp16_tpu.models.model import Model, build_model, build_model_from_string
from kaldi_fp16_tpu.models.network import Network, init_params, forward
