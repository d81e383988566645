"""The control: the reference put in the program's place one precision
below the cell's (fp8 products for bfloat16, TF32 for float32). On the CPU
at a tiny size it reads well above the bfloat16 program; on the card, at
the cell's own size, it fails the cell's limits."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, spec
from benchmark.calibrate import CONTROL
from benchmark.tests.tiny import card, tiny_cell
from benchmark.yardstick import compare

SEED = 4242


@pytest.mark.parametrize("name", ["bert-large.seq512", "gpt2-medium.seq1024"])
def test_fp8_control_reads_above_the_bf16_program(name):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    cell["config"].update({"hidden_size": 64, "intermediate_size": 256} if "bert" in name
                          else {"n_embd": 64})
    cell["mix"]["micro_batch"] = 8
    ref = harness.reference(cell, SEED, "cpu", "f32")
    control = compare.gaps(harness.reference(cell, SEED, "cpu", "fp8"), ref,
                           cell["mix"]["num_micro_batches"])
    prog = harness.run(name, SEED, 0.0, False, device="cpu", cell=cell)["checks"]
    assert max(control[k] / prog[k]["value"] for k in prog) >= 3.0, (control, prog)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark_json()["workloads"]])
def test_control_fails_the_cell_on_the_card(name):
    card()
    cell = spec.cell(name)
    dev = torch.device("cuda", 0)
    low = harness.reference(cell, SEED, dev, CONTROL[cell["work"]["precision"]])
    ref = harness.reference(cell, SEED, dev, "f32")
    numbers = compare.gaps(low, ref, cell["mix"]["num_micro_batches"])
    assert not compare.verdict(numbers, cell["work"]["limits"])
