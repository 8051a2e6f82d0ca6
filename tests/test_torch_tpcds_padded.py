"""PyTorch port, TPC-DS with every string padded (``dict_max_size=0`` in
both packages): the queries with string group or sort keys, q43 (the day
pivot per store name and id), q27 and q22 (ROLLUP over padded keys beside
typed null literals), q33 and q56 (a Union of three channels' aggregates)
and q62 (a pivot per warehouse, ship mode and site name), each held to the
JAX ``Session`` as in the default staging. The helpers are
``_torch_tpcds.py``'s."""

import pytest

import _torch_tpcds as H
from test_torch_hints import jax_attempts  # noqa: F401 (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("q", ["q43", "q27", "q22", "q33", "q56", "q62"])
def test_padded_direct_matches_jax(jax_attempts, q):
    H.check_direct(q, jax_attempts, staging="padded")
