"""The controls of ``correct`` on the card, at each cell's own size: the
reference computed in the precision below the configuration's, put in the
program's place, has to come out not correct on each of three seeds (fp8 for
the bf16 render cells, TF32 for the float32 training cell), and so has the
training cell's half-batch fault; the program itself has to come out
correct.  A one-second window a seed; about four minutes on one H100."""

import pytest

from benchmark import spec
from benchmark.run import execute

SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


def failed_one(readings: dict, limits: dict) -> bool:
    return any(not readings[k] <= limits[k]["limit"] for k in readings)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dtu_eval.hd_stream", "dtu_pretrain.train"])
def test_controls_fail_and_the_program_passes(cell, cuda_card):
    c = spec.load_cell(cell)
    for seed in SEEDS:
        out = execute(c, seed, 1.0, False, "cuda", controls=True)
        assert out["result"]["correct"], out["result"]["checks"]
        lows = [k for k in ("fp8", "tf32", "half_batch") if k in out["controls"]]
        assert lows
        for k in lows:
            assert failed_one(out["controls"][k], c.limits), (seed, k, out["controls"][k])
