"""End-to-end training demo of the PyTorch port: train a small config with
async layered checkpoints, crash mid-run, and resume exactly.

Run:  PYTHONPATH=src python examples/torch_train_resume.py            # on the GPU
      PYTHONPATH=src python examples/torch_train_resume.py --device cpu
"""

import argparse
import os
import subprocess
import sys
import tempfile

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
device = ap.parse_args().device

src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
env = dict(os.environ, PYTHONPATH=src)
workdir = tempfile.mkdtemp(prefix="torch_train_example_")
base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-3b",
        "--steps", "30", "--batch", "4", "--seq", "64",
        "--checkpoint-every", "10", "--workdir", workdir, "--device", device]

print("=== phase 1: run until simulated failure at step 17 ===", flush=True)
r = subprocess.run(base + ["--simulate-failure", "17"], env=env)
assert r.returncode == 17, r.returncode

print("=== phase 2: resume from the last durable checkpoint ===", flush=True)
r = subprocess.run(base + ["--resume"], env=env)
assert r.returncode == 0, r.returncode
print("resumed and completed OK")
