"""PyTorch port, the TPC-DS generator (``models/tpcds.py``): every column of
all 24 tables equals the JAX package's, dtype and values, at SF 0.02 and
SF 1, and both packages declare the same schemas. The port's module lists
all 99 queries."""

import numpy as np
import pytest

from datafusion_comet_tpu.models import tpcds as JTPCDS
from datafusion_comet_tpu_torch.models import tpcds


@pytest.mark.parametrize("sf", [0.02, 1.0])
@pytest.mark.parametrize("table", sorted(JTPCDS.SCHEMAS))
def test_generator_is_bit_identical(table, sf):
    want, got = JTPCDS.generate_table(table, sf), tpcds.generate_table(table, sf)
    assert list(want) == list(got) == tpcds.SCHEMAS[table].names
    for col in want:
        assert want[col].dtype == got[col].dtype, col
        np.testing.assert_array_equal(want[col], got[col], err_msg=col)
    assert [(f.name, f.dtype.type_id, f.dtype.precision, f.dtype.scale, f.nullable)
            for f in tpcds.SCHEMAS[table].fields] == \
        [(f.name, f.dtype.type_id, f.dtype.precision, f.dtype.scale, f.nullable)
         for f in JTPCDS.SCHEMAS[table].fields]


def test_queries_are_the_81_ported():
    """(Named when 81 were ported; since the Window operator 98, since the
    scalar subqueries all 99.)"""
    assert set(tpcds.QUERIES) == {f"q{i}" for i in range(1, 100)}
    assert len(tpcds.QUERIES) == 99 and tpcds.DATA_VERSION == JTPCDS.DATA_VERSION
