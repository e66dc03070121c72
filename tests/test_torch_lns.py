"""PyTorch port, the paper's arithmetic: carry-ins, lns_op_raw, lns_op and
the rounding oracle, against the JAX package.

Every comparison is exhaustive and bitwise: the results are FP8 codes and
carry bits, integer-domain values with no tolerance.  Binary ops run over
all 65,536 code pairs, unary ops over all 256 codes.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carry_ins as jcarry
from repro.core import formats as jformats
from repro.core import lns as jlns
from repro.core import rounding as jrounding
from repro_torch.core import carry_ins, formats, lns, rounding

FMTS = ("e5m2", "e4m3")
OPS = ("mul", "div", "square", "recip", "sqrt", "rsqrt")
MODES = ("rne", "rna", "rnz", "ru", "rd", "rz", "faithful")
CELLS = list(itertools.product(FMTS, OPS, MODES))


def _operands(op):
    """All code pairs (binary ops) or all codes (unary), as uint8 numpy."""
    codes = np.arange(256, dtype=np.uint8)
    if op in ("mul", "div"):
        X, Y = np.meshgrid(codes, codes, indexing="ij")
        return X.ravel(), Y.ravel()
    return codes, None


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_registry_matches_reference_cell_by_cell():
    assert set(carry_ins.CARRY_INS) == set(jcarry.CARRY_INS)
    for key, modes in jcarry.CARRY_INS.items():
        assert set(carry_ins.CARRY_INS[key]) == set(modes)
        for mode, spec in modes.items():
            port = carry_ins.CARRY_INS[key][mode]
            if spec is None or isinstance(spec, int):
                assert port == spec, (key, mode)
            else:
                assert callable(port) and port.__name__ == spec.__name__
    assert lns.RSQRT_NEG_FIRST == jlns.RSQRT_NEG_FIRST
    assert lns.LNS_CONSTS == jlns.LNS_CONSTS


def test_fifteen_dash_cells():
    dashes = [c for c in CELLS if jcarry.CARRY_INS[c[:2]][c[2]] is None]
    assert len(dashes) == 15 and len(CELLS) - len(dashes) == 69
    for f, op, mode in dashes:
        assert carry_ins.CARRY_INS[(f, op)][mode] is None


@pytest.mark.parametrize("fmt,op,mode", CELLS)
def test_carry_in_bitwise(fmt, op, mode):
    X, Y = _operands(op)
    if jcarry.CARRY_INS[(fmt, op)][mode] is None:
        with pytest.raises(carry_ins.Unsupported):
            carry_ins.carry_in(fmt, op, mode, _t(X), _t(Y))
        return
    want = np.broadcast_to(np.asarray(jcarry.carry_in(fmt, op, mode, _j(X),
                                                      _j(Y))), X.shape)
    got = carry_ins.carry_in(fmt, op, mode, _t(X).to(torch.int32),
                             _t(Y) if Y is None else _t(Y).to(torch.int32))
    got = np.broadcast_to(np.asarray(got), X.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt,op", list(itertools.product(FMTS, OPS)))
def test_stochastic_carry_in_and_directed_pair(fmt, op):
    X, Y = _operands(op)
    assert carry_ins.supports_stochastic(fmt, op) == \
        jcarry.supports_stochastic(fmt, op)
    if not jcarry.supports_stochastic(fmt, op):
        with pytest.raises(carry_ins.Unsupported):
            carry_ins.directed_pair(fmt, op)
        with pytest.raises(carry_ins.Unsupported):
            carry_ins.stochastic_carry_in(fmt, op, _t(X), _t(Y), rbits=1)
        return
    for got, want in zip(carry_ins.directed_pair(fmt, op),
                         jcarry.directed_pair(fmt, op)):
        if isinstance(want, int):
            assert got == want
        else:
            assert got.__name__ == want.__name__
    r = np.random.default_rng(0).integers(0, 2, X.shape).astype(np.int32)
    want = jcarry.stochastic_carry_in(fmt, op, _j(X), _j(Y),
                                      rbits=jnp.asarray(r))
    got = carry_ins.stochastic_carry_in(
        fmt, op, _t(X).to(torch.int32),
        None if Y is None else _t(Y).to(torch.int32), rbits=_t(r))
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(got), X.shape),
                                  np.broadcast_to(np.asarray(want), X.shape))


@pytest.mark.parametrize("fmt,op,mode", CELLS)
def test_lns_op_raw_and_lns_op_bitwise(fmt, op, mode):
    X, Y = _operands(op)
    if jcarry.CARRY_INS[(fmt, op)][mode] is None:
        for f in (lns.lns_op_raw, lns.lns_op):
            with pytest.raises(carry_ins.Unsupported):
                f(fmt, op, mode, _t(X), _t(Y))
        return
    for jf, f in ((jlns.lns_op_raw, lns.lns_op_raw),
                  (jlns.lns_op, lns.lns_op)):
        want = np.asarray(jf(fmt, op, mode, _j(X), _j(Y)))
        got = f(fmt, op, mode, _t(X), _t(Y))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.__name__)
        # numpy operands give the same codes as a numpy array
        np.testing.assert_array_equal(f(fmt, op, mode, X, Y), want)


@pytest.mark.parametrize("fmt,op", [
    c for c in itertools.product(FMTS, OPS) if jcarry.supports_stochastic(*c)])
def test_stochastic_lns_op_bitwise(fmt, op):
    X, Y = _operands(op)
    r = np.random.default_rng(1).integers(0, 2, X.shape).astype(np.int32)
    for jf, f in ((jlns.lns_op_raw, lns.lns_op_raw),
                  (jlns.lns_op, lns.lns_op)):
        want = np.asarray(jf(fmt, op, "stochastic", _j(X), _j(Y),
                             rbits=jnp.asarray(r)))
        got = f(fmt, op, "stochastic", _t(X), _t(Y), rbits=_t(r))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="rbits"):
        lns.lns_op(fmt, op, "stochastic", _t(X), _t(Y))


def test_rsqrt_core_is_a_floor_shift_of_the_negated_code():
    """rsqrt's core is floor(-X / 2) for every code, whatever the sign."""
    X = torch.arange(256, dtype=torch.int32)
    core = lns._lns_core(formats.E4M3, "rsqrt", X)
    assert torch.equal(core, torch.floor(-X / 2).to(torch.int32))
    mx = X & 0x7F
    _, mag = lns._signed_lns_parts(formats.E4M3, "rsqrt", X)
    assert torch.equal(mag - lns.folded_constant("e4m3", "rsqrt"),
                       -((mx + 1) >> 1))


def test_special_cases_in_the_reference_order():
    e4, e5 = formats.E4M3, formats.E5M2
    # sqrt/rsqrt of -0 is NaN; 0/0 keeps the sign bit with the NaN code
    assert int(lns.lns_op(e4, "sqrt", "rne", 0x80)) == e4.nan_code
    assert int(lns.lns_op(e4, "rsqrt", "rne", 0x80)) == e4.nan_code
    assert int(lns.lns_op(e4, "div", "rne", 0x80, 0x00)) == 0xFF
    # underflow keeps the sign
    assert int(lns.lns_op(e5, "mul", "rne", 0x84, 0x04)) == 0x80


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("op", OPS)
def test_oracle_copy_equal_to_reference(fmt, op):
    X, Y = _operands(op)
    got, gv = rounding.Oracle(formats.FORMATS[fmt]).quantize_all(op, X, Y)
    want, wv = jrounding.Oracle(jformats.FORMATS[fmt]).quantize_all(op, X, Y)
    np.testing.assert_array_equal(gv, wv)
    assert set(got) == set(want)
    for mode in want:
        np.testing.assert_array_equal(got[mode], want[mode], err_msg=mode)
    assert rounding.MODES == jrounding.MODES


def test_tables_2_3_through_the_ports_lns_op():
    """The paper's central claim, through the saturating ``lns_op``: every
    supported cell is correctly rounded (faithful for ``faithful``) on
    the oracle's valid domain -- 69/69 cells."""
    total = passed = 0
    for fmt in FMTS:
        oracle = rounding.Oracle(formats.FORMATS[fmt])
        for op in OPS:
            X, Y = _operands(op)
            expected, valid = oracle.quantize_all(op, X, Y)
            for mode in MODES:
                if carry_ins.CARRY_INS[(fmt, op)][mode] is None:
                    continue
                got = lns.lns_op(fmt, op, mode, X, Y)
                if mode == "faithful":
                    ok = (got == expected["rd"]) | (got == expected["ru"])
                else:
                    ok = got == expected[mode]
                total += 1
                passed += int((~ok & valid).sum()) == 0
    assert (passed, total) == (69, 69)
