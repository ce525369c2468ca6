"""The control at a tiny size on the CPU: the reference in float8 put in
the program's place fails the cell's limits, where the program passes."""

import pytest

from benchmark.tests import tiny


@pytest.mark.parametrize("cell,seed", [("ds2_bigru800.train", 2 ** 31 + 21),
                                       ("ds2_bilstm800.train", 2 ** 31 + 22),
                                       ("ds2_bilstm800.serve", 2 ** 31 + 23)])
def test_control_fails_where_the_program_passes(cell, seed):
    ctx = tiny.context(cell, seed=seed, seconds=2.0)
    entry = tiny.entry(ctx.mix["entry"])
    keep: dict = {}
    out = entry.control_readings(ctx, keep, True)
    if "svc" in keep:
        keep["svc"].close()
    lim = ctx.limits
    assert all(out["program"][k] <= lim[k] for k in lim)
    assert any(out["control_fp8"][k] > lim[k] for k in lim)
