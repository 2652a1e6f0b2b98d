"""The control at a size the CPU holds: the harness run of the tiny bf16
cell with the fp8 control put in the program's place for the comparison
(the float32 reference computed with fp8 products, ``Decoder(precision=
"fp8")``, whose first tokens are judged in place of the served ones)
comes out not correct at the cell's own limit, where the program's own
served tokens keep it.  On the card the control is read the same way at
the cells' own sizes by ``calibrate.py`` (PERF.md gives its readings)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny as T  # noqa: E402

LIMIT = 0.08    # ten seeds: the program read 0-0.023, the control 0.28-0.81


@pytest.mark.parametrize("seed", [2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3])
def test_fp8_control_fails_where_the_program_passes(seed):
    c = T.cell(limit=LIMIT, dtype="bfloat16", new_tokens=8,
               check_requests=4)
    res = T.run(c, seed=seed, control=True)
    assert res["checks"]["logit_gap"]["value"] > LIMIT, res["checks"]
    assert res["correct"] is False
    assert res["served_gap"] <= LIMIT, res["served_gap"]
    assert T.run(c, seed=seed)["correct"] is True
