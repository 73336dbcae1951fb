"""The golden bits of K4 and K5 (``tests/golden/cheb_fwd_digest.json``)
against the cases the card test ``test_cheb_fwd_kernel_bits`` computes
(``card_checks.CHEB_BIT_CASES``) and against what the kernel's output is by
construction: K5 writes K4's G bit for bit, and ``final_hi`` changes the
closing product alone, so the carries are the same with it and without.
The card test compares the kernel's own digests with this file; these
checks need no card."""

import json
import re
from pathlib import Path

import pytest
from card_checks import CHEB_BIT_ARRAYS, CHEB_BIT_CASES, CHEB_BIT_DEGREE, cheb_bit_case

GOLDEN = Path(__file__).resolve().parent / "golden" / "cheb_fwd_digest.json"
CARRIES = ("K5.b1r", "K5.b1i", "K5.b2r", "K5.b2i")


@pytest.fixture(scope="module")
def golden():
    doc = json.loads(GOLDEN.read_text())
    assert doc["degree"] == CHEB_BIT_DEGREE
    return doc["digests"]


def test_cheb_digest_golden_has_the_cases(golden):
    assert sorted(golden) == sorted(cheb_bit_case(*case, final_hi) for case in CHEB_BIT_CASES
                                    for final_hi in (False, True))


@pytest.mark.parametrize("final_hi", [False, True])
@pytest.mark.parametrize("case", CHEB_BIT_CASES)
def test_cheb_digest_golden_case(golden, case, final_hi):
    d = golden[cheb_bit_case(*case, final_hi)]
    assert sorted(d) == sorted(CHEB_BIT_ARRAYS)
    assert all(re.fullmatch("[0-9a-f]{64}", v) for v in d.values())
    assert d["K5.Gr"] == d["K4.Gr"] and d["K5.Gi"] == d["K4.Gi"]
    other = golden[cheb_bit_case(*case, not final_hi)]
    assert all(d[k] == other[k] for k in CARRIES)
    assert d["K4.Gr"] != other["K4.Gr"] and d["K4.Gi"] != other["K4.Gi"]
