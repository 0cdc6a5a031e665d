"""`scripts/chain_count.weigh`, the per-pixel operation count that bounds
the chain kernel, on hand-made SASS blocks of colorchecker's rolled patch
loop (the real source lines, gcov counts of 12 patches): the prologue
counts once a call and the body once an iteration, although the loop's
`for` line, which runs once a call more than the body, has an
instruction in each block."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import chain_count  # noqa: E402

PIXELS = 100
PATCHES = 12


def _line(src, text, after=0):
    return next(i for i, ln in enumerate(src, 1)
                if i > after and text in ln)


@pytest.fixture(scope="module")
def loop():
    """(blocks, counts, funcs, src) of one colorchecker stage over PIXELS
    pixels: a prologue block (the affine part's 2 float32 instructions and
    the loop's first test) and a body block (2 float32 instructions, the
    loop's increment and test)."""
    src = open(chain_count.SOURCE).read().splitlines()
    start = _line(src, "void colorchecker(")
    affine = _line(src, "float oL =", start)
    header = _line(src, "for (int j = 0; j < N; ++j)", start)
    body = _line(src, "float r2 =", start)
    end = _line(src, "}", _line(src, "v[2] = ob;", start))
    call = _line(src, "colorchecker(v, k, a);", end)
    case = _line(src, "case OP_COLORCHECKER:")
    switch = _line(src, "switch (rec[0])")
    default = _line(src, "default:", switch)
    counts = {affine: PIXELS, header: (PATCHES + 1) * PIXELS,
              body: PATCHES * PIXELS, case: PIXELS}
    # the kernel, and `apply` as a template instantiated more than once
    funcs = [(start, end, PIXELS), (switch - 1, default + 1, 1),
             (call - 1, call + 1, PIXELS), (call - 1, call + 1, PIXELS)]

    def at(line):
        return ((line, True), (call, True), (case, True))

    blocks = [[("FMUL R4, R26, R13", at(affine)),
               ("FADD R4, R13, R4", at(affine)),
               ("ISETP.GE.AND P0, PT, R3, 0x1, PT", at(header)),
               ("@!P0 BRA `(.L_x_1)", at(header))],
              [("FADD R5, R26, -R5", at(body)),
               ("FMUL R5, R5, R5", at(body)),
               ("IADD3 R6, R6, 0x4, RZ", at(header)),
               ("ISETP.LE.AND P0, PT, R3, UR4, PT", at(header)),
               ("@!P0 BRA `(.L_x_2)", at(header))]]
    return blocks, counts, funcs, src


@pytest.mark.parametrize("which, fp32", [("prologue", 2),
                                         ("body", 2 * PATCHES),
                                         ("both", 2 + 2 * PATCHES)])
def test_rolled_loop_prologue_counts_once_a_call(loop, which, fp32):
    blocks, counts, funcs, src = loop
    pick = {"prologue": blocks[:1], "body": blocks[1:], "both": blocks}
    _, bodies = chain_count.weigh(pick[which], counts, funcs, PIXELS, src)
    assert bodies["fp32"] == fp32
    assert bodies["mufu"] == 0
