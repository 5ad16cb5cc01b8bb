"""Foreign-bytes fixtures for the binary nnet3 component grammar.

Every other binary-format test round-trips through this repo's OWN
reader/writer pair, which cannot catch a self-consistent-but-wrong
encoding.  Here the byte streams are HAND-BUILT
with raw struct.pack from real Kaldi's Write() grammars — io-funcs
primitives (token + ' ', sized WriteBasicType scalars, 'T'/'F' bools,
"FV"/"FM" vectors/matrices, WriteIntegerVector, WriteIntegerPairVector)
composed in the ExpectToken orders of nnet-simple-component.cc
(NaturalGradientAffine, Linear), nnet-normalize-component.cc (BatchNorm:
double <Count>), nnet-tdnn-component.cc (Tdnn: <TimeOffsets> +
<NumSamplesHistory>/<AlphaInOut>/<RankInOut> natural-gradient tail) and
nnet-convolutional-component.cc + convolution.cc
(TimeHeightConvolution: <Model> <ConvolutionModel> block with the
PAIR-vector <Offsets>, then <MaxMemoryMb> + NG tail).  The <Model> token
and the updatable-prologue order are additionally pinned by the
captured nnet3-copy text fixture (test_kaldi_loader.py FIXTURE; ref
weight_loader.go:617-728 consumes that same text dialect).

Asserted, per component family:
  1. io/nnet3_binary.py's reader parses the foreign bytes correctly,
  2. read -> write replays the exact bytes (type inference must not
     corrupt untagged payloads like the second <RankInOut> int),
  3. components_from_text emits byte-IDENTICAL streams for the same
     component — our writer is pinned to the grammar with no repo code
     on the fixture side of the test.
"""

import struct

import numpy as np

from kaldi_fp16_tpu.io.kaldi_io import BinaryReader, BinaryWriter
from kaldi_fp16_tpu.io.nnet3_binary import (
    components_from_text, read_component, read_nnet3, write_component,
)
from kaldi_fp16_tpu.models.kaldi_loader import KaldiComponent


# -- raw Kaldi io-funcs primitives (independent of the repo's writers) ----

def tok(s: str) -> bytes:
    """WriteToken: ASCII + one trailing space."""
    return s.encode("ascii") + b" "


def i32(v: int) -> bytes:
    """WriteBasicType<int32>: size byte 4 + LE payload."""
    return b"\x04" + struct.pack("<i", v)


def f32(v: float) -> bytes:
    """WriteBasicType<BaseFloat=float>: size byte 4 + LE payload."""
    return b"\x04" + struct.pack("<f", v)


def f64(v: float) -> bytes:
    """WriteBasicType<double>: size byte 8 + LE payload."""
    return b"\x08" + struct.pack("<d", v)


def boolean(v: bool) -> bytes:
    return b"T" if v else b"F"


def fv(a) -> bytes:
    """Vector<float>::Write: "FV " + dim + raw floats."""
    a = np.asarray(a, "<f4")
    return tok("FV") + i32(len(a)) + a.tobytes()


def fm(a) -> bytes:
    """Matrix<float>::Write: "FM " + rows + cols + raw floats."""
    a = np.asarray(a, "<f4")
    return tok("FM") + i32(a.shape[0]) + i32(a.shape[1]) + a.tobytes()


def ivec(vals) -> bytes:
    """WriteIntegerVector<int32>: size byte + count + raw block."""
    a = np.asarray(vals, "<i4")
    return i32(len(a)) + a.tobytes()


def ipairvec(pairs) -> bytes:
    """WriteIntegerPairVector<int32>: count = #PAIRS, then 2*count raw
    int32s (kaldi io-funcs-inl.h) — NOT a flat WriteIntegerVector."""
    flat = np.asarray([v for p in pairs for v in p], "<i4")
    return i32(len(pairs)) + flat.tobytes()


# -- fixture parameter data (deterministic) -------------------------------

RNG = np.random.default_rng(1234)
W_AFF = RNG.normal(size=(3, 4)).astype(np.float32)
B_AFF = RNG.normal(size=3).astype(np.float32)
W_LIN = RNG.normal(size=(2, 5)).astype(np.float32)
MEAN = RNG.normal(size=4).astype(np.float32)
VAR = RNG.uniform(0.5, 2.0, size=4).astype(np.float32)
W_TDNN = RNG.normal(size=(4, 8)).astype(np.float32)
B_TDNN = RNG.normal(size=4).astype(np.float32)
W_CONV = RNG.normal(size=(8, 12)).astype(np.float32)
B_CONV = RNG.normal(size=8).astype(np.float32)
CONV_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1)]


def ng_affine_bytes() -> bytes:
    return (
        tok("<NaturalGradientAffineComponent>")
        + tok("<MaxChange>") + f32(0.75)
        + tok("<LearningRate>") + f32(1e-3)
        + tok("<LinearParams>") + fm(W_AFF)
        + tok("<BiasParams>") + fv(B_AFF)
        + tok("<RankIn>") + i32(20)
        + tok("<RankOut>") + i32(80)
        + tok("<UpdatePeriod>") + i32(4)
        + tok("<NumSamplesHistory>") + f32(2000.0)
        + tok("<Alpha>") + f32(4.0)
        + tok("</NaturalGradientAffineComponent>"))


def linear_bytes() -> bytes:
    return (
        tok("<LinearComponent>")
        + tok("<LearningRate>") + f32(2e-4)
        + tok("<Params>") + fm(W_LIN)
        + tok("<OrthonormalConstraint>") + f32(0.0)
        + tok("<UseNaturalGradient>") + boolean(True)
        + tok("</LinearComponent>"))


def batchnorm_bytes() -> bytes:
    return (
        tok("<BatchNormComponent>")
        + tok("<Dim>") + i32(4)
        + tok("<BlockDim>") + i32(4)
        + tok("<Epsilon>") + f32(1e-3)
        + tok("<TargetRms>") + f32(1.0)
        + tok("<TestMode>") + boolean(False)
        + tok("<Count>") + f64(176000.0)     # count_ is a DOUBLE in Kaldi
        + tok("<StatsMean>") + fv(MEAN)
        + tok("<StatsVar>") + fv(VAR)
        + tok("</BatchNormComponent>"))


def tdnn_bytes() -> bytes:
    return (
        tok("<TdnnComponent>")
        + tok("<LearningRate>") + f32(1e-4)
        + tok("<TimeOffsets>") + ivec([-3, 0])
        + tok("<LinearParams>") + fm(W_TDNN)
        + tok("<BiasParams>") + fv(B_TDNN)
        + tok("<OrthonormalConstraint>") + f32(0.0)
        + tok("<UseNaturalGradient>") + boolean(True)
        + tok("<NumSamplesHistory>") + f32(2000.0)
        + tok("<AlphaInOut>") + f32(4.0) + f32(4.0)
        + tok("<RankInOut>") + i32(20) + i32(80)
        + tok("</TdnnComponent>"))


def conv_bytes() -> bytes:
    return (
        tok("<TimeHeightConvolutionComponent>")
        + tok("<LearningRate>") + f32(3.33e-5)
        + tok("<Model>")
        + tok("<ConvolutionModel>")
        + tok("<NumFiltersIn>") + i32(2)
        + tok("<NumFiltersOut>") + i32(8)
        + tok("<HeightIn>") + i32(3)
        + tok("<HeightOut>") + i32(3)
        + tok("<HeightSubsampleOut>") + i32(1)
        + tok("<Offsets>") + ipairvec(CONV_OFFSETS)
        + tok("<RequiredTimeOffsets>") + ivec([-1, 0])
        + tok("</ConvolutionModel>")
        + tok("<LinearParams>") + fm(W_CONV)
        + tok("<BiasParams>") + fv(B_CONV)
        + tok("<MaxMemoryMb>") + f32(200.0)
        + tok("<UseNaturalGradient>") + boolean(True)
        + tok("<NumMinibatchesHistory>") + f32(4.0)
        + tok("<AlphaInOut>") + f32(4.0) + f32(4.0)
        + tok("<RankInOut>") + i32(20) + i32(80)
        + tok("</TimeHeightConvolutionComponent>"))


def _read(data: bytes):
    return read_component(BinaryReader(data))


def _replay(data: bytes) -> bytes:
    w = BinaryWriter()
    write_component(w, _read(data))
    return w.getvalue()


class TestForeignRead:
    def test_ng_affine(self):
        c = _read(ng_affine_bytes())
        assert c.type == "NaturalGradientAffineComponent"
        assert abs(c.scalars["<MaxChange>"] - 0.75) < 1e-7
        assert abs(c.scalars["<LearningRate>"] - 1e-3) < 1e-9
        np.testing.assert_array_equal(c.matrices["<LinearParams>"], W_AFF)
        np.testing.assert_array_equal(c.vectors["<BiasParams>"], B_AFF)
        assert c.ints["<RankIn>"] == 20 and c.ints["<RankOut>"] == 80
        assert c.ints["<UpdatePeriod>"] == 4
        assert abs(c.scalars["<NumSamplesHistory>"] - 2000.0) < 1e-3
        assert abs(c.scalars["<Alpha>"] - 4.0) < 1e-7

    def test_linear(self):
        c = _read(linear_bytes())
        np.testing.assert_array_equal(c.matrices["<Params>"], W_LIN)
        assert c.bools["<UseNaturalGradient>"] is True
        assert c.scalars["<OrthonormalConstraint>"] == 0.0

    def test_batchnorm_double_count(self):
        c = _read(batchnorm_bytes())
        assert c.ints["<Dim>"] == 4 and c.ints["<BlockDim>"] == 4
        assert c.bools["<TestMode>"] is False
        # the 8-byte double payload must parse as the count value
        assert c.scalars["<Count>"] == 176000.0
        np.testing.assert_array_equal(c.vectors["<StatsMean>"], MEAN)
        np.testing.assert_array_equal(c.vectors["<StatsVar>"], VAR)

    def test_tdnn(self):
        c = _read(tdnn_bytes())
        assert c.int_vectors["<TimeOffsets>"].tolist() == [-3, 0]
        np.testing.assert_array_equal(c.matrices["<LinearParams>"], W_TDNN)
        # two-payload tags: first value tagged, second untagged
        assert c.ints["<RankInOut>"] == 20
        untagged = [(k, v) for t, k, v in c.items if t is None]
        assert ("int", 80) in untagged
        assert any(k == "float" and abs(v - 4.0) < 1e-7
                   for k, v in untagged)

    def test_conv_pair_vector_offsets(self):
        c = _read(conv_bytes())
        # pair-vector framing: count was #pairs, values come back flat
        assert c.int_vectors["<Offsets>"].tolist() == [
            v for p in CONV_OFFSETS for v in p]
        assert c.int_vectors["<RequiredTimeOffsets>"].tolist() == [-1, 0]
        assert "<Model>" in c.flags and "<ConvolutionModel>" in c.flags
        assert "</ConvolutionModel>" in c.flags
        np.testing.assert_array_equal(c.matrices["<LinearParams>"], W_CONV)
        assert abs(c.scalars["<MaxMemoryMb>"] - 200.0) < 1e-4


class TestForeignReplay:
    """read -> write of foreign bytes must be byte-identical (the tag
    order AND the payload typing survive, incl. untagged second values
    of <AlphaInOut>/<RankInOut> and the pair-vector <Offsets> count)."""

    def test_all_families(self):
        for make in (ng_affine_bytes, linear_bytes, batchnorm_bytes,
                     tdnn_bytes, conv_bytes):
            data = make()
            assert _replay(data) == data, make.__name__


class TestEmitterMatchesForeignBytes:
    """components_from_text must emit the EXACT foreign byte stream for
    an equivalent component — no repo code on the fixture side."""

    @staticmethod
    def _emit(kc: KaldiComponent) -> bytes:
        [bc] = components_from_text({kc.name: kc})
        w = BinaryWriter()
        write_component(w, bc)
        return w.getvalue()

    def test_ng_affine(self):
        kc = KaldiComponent(
            name="a", type="NaturalGradientAffineComponent",
            linear_params=W_AFF, bias_params=B_AFF,
            max_change=0.75, learning_rate=1e-3)
        assert self._emit(kc) == ng_affine_bytes()

    def test_linear(self):
        kc = KaldiComponent(name="l", type="LinearComponent",
                            linear_params=W_LIN, learning_rate=2e-4)
        assert self._emit(kc) == linear_bytes()

    def test_batchnorm(self):
        kc = KaldiComponent(name="bn", type="BatchNormComponent",
                            stats_mean=MEAN, stats_var=VAR,
                            epsilon=1e-3, target_rms=1.0, count=176000.0)
        assert self._emit(kc) == batchnorm_bytes()

    def test_tdnn(self):
        kc = KaldiComponent(name="t", type="TdnnComponent",
                            linear_params=W_TDNN, bias_params=B_TDNN,
                            learning_rate=1e-4, time_offsets=[-3, 0])
        assert self._emit(kc) == tdnn_bytes()

    def test_conv(self):
        kc = KaldiComponent(name="c", type="TimeHeightConvolutionComponent",
                            linear_params=W_CONV, bias_params=B_CONV,
                            learning_rate=3.33e-5,
                            num_filters_in=2, num_filters_out=8,
                            height_in=3, height_out=3, height_subsample=1,
                            offsets=CONV_OFFSETS)
        assert self._emit(kc) == conv_bytes()


class TestForeignWholeFile:
    """A hand-built .raw-style <Nnet3> container (with Kaldi's
    newline-after-component layout) must parse; the component payloads
    must survive the file-level reader."""

    def _file_bytes(self) -> bytes:
        config = (b"input-node name=input dim=4\n"
                  b"component-node name=a component=a input=input\n"
                  b"output-node name=output input=a\n")
        body = b""
        for name, comp in (("a", ng_affine_bytes()),
                           ("bn", batchnorm_bytes()),
                           ("c", conv_bytes())):
            body += tok("<ComponentName>") + tok(name) + comp + b"\n"
        return (b"\x00B" + tok("<Nnet3>") + b"\n" + config + b"\n"
                + tok("<NumComponents>") + i32(3) + body
                + tok("</Nnet3>"))

    def test_parses(self):
        m = read_nnet3(self._file_bytes())
        assert [c.name for c in m.components] == ["a", "bn", "c"]
        assert m.components[0].type == "NaturalGradientAffineComponent"
        np.testing.assert_array_equal(
            m.component("a").matrices["<LinearParams>"], W_AFF)
        assert m.component("bn").scalars["<Count>"] == 176000.0
        assert m.component("c").int_vectors["<Offsets>"].tolist() == [
            v for p in CONV_OFFSETS for v in p]
        assert len(m.config_lines) == 3

    def test_bridge_to_text_components(self):
        from kaldi_fp16_tpu.io.nnet3_binary import to_kaldi_components
        kcs = to_kaldi_components(read_nnet3(self._file_bytes()))
        assert kcs["c"].offsets == CONV_OFFSETS
        assert kcs["bn"].count == 176000.0
