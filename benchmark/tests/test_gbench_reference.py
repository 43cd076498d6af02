"""The plain reference against the port's plain path at a size the CPU
holds, and what the reference loads."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import port
from benchmark.harness.spec import ROOT
from benchmark.harness.weights import make_weights
from benchmark.reference.model import logits_at, served_gaps
from benchmark.tests import tiny


@pytest.mark.parametrize("window", [None, 16])
def test_reference_matches_the_ports_plain_forward(window):
    from grasp_tpu_torch.models.llama import forward, plan_from_params

    cfg = dict(tiny.CONFIG, sliding_window=window, port={"dtype": "float32"})
    w = make_weights(cfg, 11, "cpu", dtype=torch.float32)
    config = port.model_config(cfg)
    params = port.params_of(w, cfg["num_hidden_layers"])
    ids = np.random.default_rng(0).integers(0, cfg["vocab_size"], size=40)
    theirs = forward(params, torch.from_numpy(ids)[None], config=config,
                     plan=plan_from_params(params, config))["logits"][0]
    ours = logits_at(w, cfg, ids.tolist(), list(range(40)))
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


def test_served_gaps_are_zero_for_the_references_own_greedy_tokens():
    cfg = tiny.CONFIG
    w = make_weights(cfg, 12, "cpu", dtype=torch.float32)
    ids = list(np.random.default_rng(1).integers(0, cfg["vocab_size"], size=20))
    served = []
    for _ in range(6):
        seq = ids + served
        served.append(int(logits_at(w, cfg, seq, [len(seq) - 1])[0].argmax()))
    assert max(served_gaps(w, cfg, ids, served)) == 0.0
    wrong = served[:3] + [(served[3] + 1) % cfg["vocab_size"]] + served[4:]
    assert served_gaps(w, cfg, ids, wrong)[3] > 0.0


def test_reference_loads_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.model, "
            "benchmark.harness.weights, benchmark.metrics.yardstick; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    loaded = eval(out)
    for name in ("jax", "jaxlib", "flax", "grasp_tpu", "grasp_tpu_torch"):
        assert name not in loaded
