"""scripts/run_quality_torch.sh (the port's run of the reference README's
table, the counterpart of scripts/run_quality.sh) end to end on the CPU in
its tiny mode: the dense row, compress and evaluate, resume, recover and
evaluate, each through the port's CLI, and table.json. Also that ``python
-m grasp_tpu_torch.cli`` runs the compression entry point, as ``python -m
grasp_tpu.cli`` does, which the script relies on.
"""

import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_quality_torch_tiny_on_the_cpu(tmp_path):
    out = tmp_path / "q"
    rec = tmp_path / "alpaca_tiny.json"
    rows = [{"instruction": f"say {w}", "input": "", "output": w}
            for w in ("hi", "ok", "go", "no", "yes", "sun", "sky", "red")]
    rec.write_text(json.dumps(rows))
    env = dict(os.environ, GRASP_QUALITY_TINY="1", DEVICE="cpu", OUT=str(out),
               RECOVERY_DATA=str(rec))
    proc = subprocess.run(["bash", os.path.join(REPO, "scripts", "run_quality_torch.sh")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]

    table = json.loads((out / "table.json").read_text())
    assert set(table) == {"dense", "grasp", "grasp_star"}
    for row, res in table.items():
        assert res and "synthetic" in res, (row, res)
        assert math.isfinite(float(res["synthetic"])) and float(res["synthetic"]) > 0
    assert (out / "grasp_ckpt" / "grasp_meta.json").exists()
    assert (out / "grasp_star_ckpt" / "grasp_meta.json").exists()


def test_module_entry_point_is_compression():
    proc = subprocess.run([sys.executable, "-m", "grasp_tpu_torch.cli", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--model_name_or_path" in proc.stdout and "--compression_ratio" in proc.stdout
