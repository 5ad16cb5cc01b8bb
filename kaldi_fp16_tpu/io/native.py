"""ctypes binding to the native cegs parser (cpp/libcegs_parser.so).

The native path is the production data-ingestion route (the reference's
Go parser analog); `NativeEgsReader` mirrors `EgsReader`'s interface and
produces identical `Example` objects.  `best_reader(path)` picks native
when the shared library is built and the file is not gzip-compressed,
falling back to the pure-Python reader otherwise.

Build: `make -C cpp` (no external dependencies).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from kaldi_fp16_tpu.io.egs import Example, Index, IoBlock, Supervision
from kaldi_fp16_tpu.io.fst import Fst, FstArc, FstState

_LIB_PATHS = [p for p in [
    # explicit override (containerized / relocated deployments)
    os.environ.get("KALDI_FP16_TPU_NATIVE_LIB"),
    # source tree: <repo>/cpp/build/libcegs_parser.so
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "cpp", "build", "libcegs_parser.so"),
    # installed package: kaldi_fp16_tpu/_native/ (make -C cpp install-pkg)
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "_native", "libcegs_parser.so"),
] if p]

_lib = None
_load_failed = False


def _load_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    override = os.environ.get("KALDI_FP16_TPU_NATIVE_LIB")
    if override and not os.path.exists(override):
        # an EXPLICIT override must be honored or fail loudly — falling
        # back to another library (or the ~10x-slower Python parser)
        # would silently ignore the deployment's configuration
        raise FileNotFoundError(
            f"KALDI_FP16_TPU_NATIVE_LIB={override} does not exist "
            f"(unset it to use the bundled/source-tree library or the "
            f"pure-Python parser)")
    for path in _LIB_PATHS:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                if path == override:
                    # an EXPLICIT override that fails to dlopen must not
                    # silently degrade to the ~10x-slower Python parser
                    raise OSError(
                        f"KALDI_FP16_TPU_NATIVE_LIB={path} exists but "
                        f"failed to load: {e}") from e
                continue
            _configure(lib)
            _lib = lib
            return _lib
    _load_failed = True
    return None


def _configure(lib):
    c = ctypes
    lib.cegs_open.restype = c.c_void_p
    lib.cegs_open.argtypes = [c.c_char_p]
    lib.cegs_close.argtypes = [c.c_void_p]
    lib.cegs_last_error.restype = c.c_char_p
    lib.cegs_last_error.argtypes = [c.c_void_p]
    lib.cegs_next.restype = c.c_int
    lib.cegs_next.argtypes = [c.c_void_p]
    for name, res in [
        ("cegs_key", c.c_char_p), ("cegs_num_inputs", c.c_int),
        ("cegs_sup_weight", c.c_float), ("cegs_sup_num_sequences", c.c_int),
        ("cegs_sup_frames_per_seq", c.c_int), ("cegs_sup_label_dim", c.c_int),
        ("cegs_sup_end2end", c.c_int), ("cegs_sup_num_indexes", c.c_int),
        ("cegs_sup_indexes", c.POINTER(c.c_int32)),
        ("cegs_sup_num_deriv_weights", c.c_int),
        ("cegs_sup_deriv_weights", c.POINTER(c.c_float)),
        ("cegs_fst_num_states", c.c_int), ("cegs_fst_start", c.c_int),
        ("cegs_fst_num_arcs", c.c_int),
        ("cegs_fst_arc_src", c.POINTER(c.c_int32)),
        ("cegs_fst_arc_dst", c.POINTER(c.c_int32)),
        ("cegs_fst_arc_label", c.POINTER(c.c_int32)),
        ("cegs_fst_arc_weight", c.POINTER(c.c_float)),
        ("cegs_fst_num_finals", c.c_int),
        ("cegs_fst_final_states", c.POINTER(c.c_int32)),
        ("cegs_fst_final_weights", c.POINTER(c.c_float)),
        ("cegs_sup_name", c.c_char_p), ("cegs_dw_fmt", c.c_int),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [c.c_void_p]
    for name, res in [
        ("cegs_input_name", c.c_char_p), ("cegs_input_rows", c.c_int),
        ("cegs_input_cols", c.c_int),
        ("cegs_input_data", c.POINTER(c.c_float)),
        ("cegs_input_num_indexes", c.c_int),
        ("cegs_input_indexes", c.POINTER(c.c_int32)),
        ("cegs_input_fmt", c.c_int),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [c.c_void_p, c.c_int]
    # packed scalar metadata (one call replaces ~15 scalar getters);
    # absent in libraries built before r5 — callers feature-detect
    if hasattr(lib, "cegs_meta"):
        lib.cegs_meta.restype = c.c_int
        lib.cegs_meta.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]


def native_available() -> bool:
    return _load_lib() is not None


def _np_copy(ptr, count, dtype):
    """Copy `count` elements from a ctypes pointer into a fresh array.
    np.frombuffer over a from_address view is ~2x faster per call than
    np.ctypeslib.as_array (which rebuilds an array type every call) —
    at ~8 copies per example this was a measurable slice of the
    128-example batch parse."""
    if count == 0:
        return np.empty(0, dtype=dtype)
    nbytes = count * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * nbytes).from_address(
        ctypes.cast(ptr, ctypes.c_void_p).value)
    return np.frombuffer(buf, dtype=dtype).copy()


class LazyIndexList:
    """Sequence view over a flat [(n,t,x), ...] int32 array that builds
    Index objects only on access.  Building them eagerly was 38% of the
    whole DataLoader hot path (~1M Index objects for 2000 examples) while
    almost nothing reads them (batch.py looks at indexes[0].t; only the
    writers/egstools iterate fully)."""

    __slots__ = ("_flat",)

    def __init__(self, flat: np.ndarray):
        self._flat = flat

    def __len__(self) -> int:
        return len(self._flat) // 3

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        f = self._flat
        return Index(int(f[3 * i]), int(f[3 * i + 1]), int(f[3 * i + 2]))

    def __iter__(self):
        f = self._flat
        for i in range(0, len(f), 3):
            yield Index(int(f[i]), int(f[i + 1]), int(f[i + 2]))

    def __bool__(self) -> bool:
        return len(self._flat) > 0

    def __eq__(self, other):
        if isinstance(other, LazyIndexList):
            return np.array_equal(self._flat, other._flat)
        try:
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        except TypeError:
            return NotImplemented

    def __repr__(self):
        return f"LazyIndexList({list(self)!r})"


def _indexes_from(flat: np.ndarray) -> "LazyIndexList":
    return LazyIndexList(flat)


class LazyStates:
    """Sequence of FstState that materializes on first element access;
    len() is free.  The DataLoader hot path never touches it — sparse
    conversions consume the flat arc arrays (fst.flat) directly."""

    __slots__ = ("_n", "_flat", "_states")

    def __init__(self, num_states: int, flat):
        self._n = num_states
        self._flat = flat
        self._states = None

    def _materialize(self):
        if self._states is None:
            src, dst, lab, wgt, fs, fw = self._flat
            states = [FstState() for _ in range(self._n)]
            for a in range(len(src)):
                states[src[a]].arcs.append(
                    FstArc(int(lab[a]), float(wgt[a]), int(dst[a])))
            for s, w in zip(fs, fw):
                states[s].final = float(w)
            self._states = states
        return self._states

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __bool__(self) -> bool:
        return self._n > 0

    def __eq__(self, other):
        try:
            return list(self) == list(other)
        except TypeError:
            return NotImplemented

    def __repr__(self):
        return f"LazyStates(n={self._n})"


class NativeEgsReader:
    """Drop-in native replacement for EgsReader (plain .ark only)."""

    def __init__(self, path: str):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native cegs parser not built (make -C cpp)")
        if path.endswith(".gz"):
            raise ValueError("native parser does not handle .gz; use EgsReader")
        self._lib = lib
        self._p = lib.cegs_open(path.encode())
        if not self._p:
            raise OSError(f"cannot open {path}")
        # reusable packed-metadata buffer (see _configure / cegs_meta);
        # None with pre-r5 libraries -> per-scalar getter fallback
        self._meta_buf = ((ctypes.c_int32 * 32)()
                          if hasattr(lib, "cegs_meta") else None)

    def close(self) -> None:
        if self._p:
            self._lib.cegs_close(self._p)
            self._p = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> Example:
        ex = self.read_example()
        if ex is None:
            raise StopIteration
        return ex

    def read_example(self) -> Optional[Example]:
        lib, p = self._lib, self._p
        rc = lib.cegs_next(p)
        if rc == 0:
            return None
        if rc < 0:
            err = lib.cegs_last_error(p)
            raise ValueError(f"native parse error: "
                             f"{err.decode() if err else 'unknown'}")

        # one packed-metadata call replaces ~15 scalar ctypes round
        # trips per example (r5; libraries without cegs_meta fall back)
        meta = None
        if self._meta_buf is not None:
            lib.cegs_meta(p, self._meta_buf)
            meta = np.frombuffer(self._meta_buf, dtype=np.int32)

        n_inputs = (int(meta[0]) if meta is not None
                    else lib.cegs_num_inputs(p))
        inputs = []
        for i in range(n_inputs):
            if meta is not None and i < 4:
                rows, cols = int(meta[13 + 4 * i]), int(meta[14 + 4 * i])
                fmt_i, n_idx = int(meta[15 + 4 * i]), int(meta[16 + 4 * i])
            else:
                rows = lib.cegs_input_rows(p, i)
                cols = lib.cegs_input_cols(p, i)
                fmt_i = lib.cegs_input_fmt(p, i)
                n_idx = lib.cegs_input_num_indexes(p, i)
            data = _np_copy(lib.cegs_input_data(p, i), rows * cols,
                            np.float32).reshape(rows, cols)
            idx = _np_copy(lib.cegs_input_indexes(p, i), n_idx * 3,
                           np.int32)
            inputs.append(IoBlock(name=lib.cegs_input_name(p, i).decode(),
                                  indexes=_indexes_from(idx), data=data,
                                  fmt=("CM", "CM2", "CM3", "FM", "SM")[fmt_i]))

        # rebuild the supervision FST: flat arrays as the source of truth
        # (sparse.fst_to_coo consumes them directly via fst.flat); the
        # per-state FstState/FstArc objects materialize only if someone
        # actually walks .states (writers, egstools totext)
        if meta is not None:
            ns, start, na, nf = (int(meta[1]), int(meta[2]), int(meta[3]),
                                 int(meta[4]))
            num_seq, fps, label_dim = (int(meta[5]), int(meta[6]),
                                       int(meta[7]))
            end2end, dw_fmt_i = int(meta[8]), int(meta[9])
            n_sup_idx, ndw = int(meta[10]), int(meta[11])
            weight = float(meta[12:13].view(np.float32)[0])
        else:
            ns, start = lib.cegs_fst_num_states(p), lib.cegs_fst_start(p)
            na, nf = lib.cegs_fst_num_arcs(p), lib.cegs_fst_num_finals(p)
            num_seq = lib.cegs_sup_num_sequences(p)
            fps = lib.cegs_sup_frames_per_seq(p)
            label_dim = lib.cegs_sup_label_dim(p)
            end2end = lib.cegs_sup_end2end(p)
            dw_fmt_i = lib.cegs_dw_fmt(p)
            n_sup_idx = lib.cegs_sup_num_indexes(p)
            ndw = lib.cegs_sup_num_deriv_weights(p)
            weight = float(lib.cegs_sup_weight(p))
        fst = None
        if ns > 0:
            src = _np_copy(lib.cegs_fst_arc_src(p), na, np.int32)
            dst = _np_copy(lib.cegs_fst_arc_dst(p), na, np.int32)
            lab = _np_copy(lib.cegs_fst_arc_label(p), na, np.int32)
            wgt = _np_copy(lib.cegs_fst_arc_weight(p), na, np.float32)
            fs = _np_copy(lib.cegs_fst_final_states(p), nf, np.int32)
            fw = _np_copy(lib.cegs_fst_final_weights(p), nf, np.float32)
            flat = (src, dst, lab, wgt, fs, fw)
            fst = Fst(start=start, states=LazyStates(ns, flat))
            fst.flat = flat

        dw = (_np_copy(lib.cegs_sup_deriv_weights(p), ndw, np.float32)
              if ndw else None)
        sup_idx = _np_copy(lib.cegs_sup_indexes(p), n_sup_idx * 3,
                           np.int32)
        sup_name = lib.cegs_sup_name(p)
        sup = Supervision(
            name=(sup_name.decode() if sup_name else "output") or "output",
            weight=weight,
            num_sequences=num_seq,
            frames_per_seq=fps,
            label_dim=label_dim,
            end2end=bool(end2end),
            fst=fst,
            indexes=_indexes_from(sup_idx),
            deriv_weights=dw,
            deriv_weights_fmt=("DW2", "DW", "DW2")[dw_fmt_i])
        return Example(key=lib.cegs_key(p).decode(), inputs=inputs,
                       supervision=sup)


def best_reader(path: str):
    """Native reader when available and applicable, else the Python one."""
    if native_available() and not path.endswith(".gz"):
        return NativeEgsReader(path)
    from kaldi_fp16_tpu.io.egs import EgsReader
    return EgsReader(path)
