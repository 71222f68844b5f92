"""The engine bridge's DECIMAL128 ops through both packages'
``bridge.call``, byte for byte on the wire with equal meta JSON
(``test_torch_bridge.py``'s inputs)."""

import pytest

from test_torch_bridge import DECIMAL_CASES, IN, assert_same, both


@pytest.mark.parametrize("op,args,names", DECIMAL_CASES,
                         ids=[c[0] for c in DECIMAL_CASES])
def test_decimal_op_matches_wire_bytes(op, args, names):
    assert_same(*both(op, args, [IN[n] for n in names]))
