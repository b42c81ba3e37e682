"""Trace one (arch × shape) cell of the PyTorch port on the meta device
against the 256-device and the 512-device production meshes, and print its
memory, cost, collective and roofline terms against H100 constants.
Nothing is allocated on any device: it runs on a host without a GPU.

Run:  PYTHONPATH=src python examples/torch_multipod_dryrun.py [arch] [shape] [--out DIR]
"""

import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

args = sys.argv[1:]
arch = args.pop(0) if args and not args[0].startswith("--") else "olmoe-1b-7b"
shape = args.pop(0) if args and not args[0].startswith("--") else "train_4k"
env = dict(os.environ)
env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
subprocess.run(
    [sys.executable, "-m", "repro_torch.launch.dryrun",
     "--arch", arch, "--shape", shape, "--both-meshes", *args],
    env=env, check=True,
)
