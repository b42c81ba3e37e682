"""Quickstart of the PyTorch port: the snapshot engine in ~70 lines, then
one snapfaas restore whose base ⊕ diff is applied on the device by the
``snapshot_patch`` kernel.

Run:  PYTHONPATH=src python examples/torch_quickstart.py            # on the GPU
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import (
    AccessLog, ZygoteRegistry, PAPER_C220G5, predict, lower_bound,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import snapshot_patch
from repro_torch.serving.worker import device_patch

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
device = resolve_device(ap.parse_args().device)

root = tempfile.mkdtemp(prefix="torch_quickstart_")
reg = ZygoteRegistry(root, chunk_bytes=64 * 1024)

# 1. Bootstrap: one base snapshot per runtime family (here: toy weights).
rng = np.random.default_rng(0)
base = {
    "embed/table": rng.standard_normal((4096, 256)).astype(np.float32),
    "layer0/w": rng.standard_normal((256, 1024)).astype(np.float32),
    "layer1/w": rng.standard_normal((1024, 256)).astype(np.float32),
}
reg.register_runtime("toy-lm", base)

# 2. Register a function: a variant that fine-tunes 32 embedding rows.
variant = {k: np.array(v) for k, v in base.items()}
variant["embed/table"][:32] += 0.1
reg.register_function("my-adapter", "toy-lm", variant)

# 3. Profile once under access tracking → working-set file (REAP-style).
log = AccessLog()
log.touch_rows("embed/table", range(32))
log.touch("layer0/w"); log.touch("layer1/w")
reg.generate_working_set("my-adapter", log)

# 4. Cold-start with each strategy and compare.
for strategy in ("reap", "snapfaas-", "snapfaas"):
    inst = reg.cold_start("my-adapter", strategy)
    np.testing.assert_array_equal(inst.value("embed/table"), variant["embed/table"])
    m = inst.metrics
    print(f"{strategy:10s} boot={m.boot_latency*1e3:7.3f} ms  "
          f"eager={m.eager_bytes/1024:8.1f} KiB  shared={m.shared_bytes_mapped/1024:8.1f} KiB")

# 5. The snapfaas restore on the device: the base table is already there,
#    only the diff chunks cross the host, and the patch kernel writes base ⊕ diff.
inst = reg.cold_start("my-adapter", "snapfaas")
ma = inst.arrays["embed/table"]
assert ma.patch is not None, "snapfaas restored embed/table without a patch"
base_dev = torch.from_numpy(base["embed/table"]).to(device)
snapshot_patch.launches.reset()
out = device_patch(base_dev, ma.patch.rows_2d(), ma.patch.sel, ma.meta.chunk_bytes)
if device.type == "cuda":
    torch.cuda.synchronize()
    assert snapshot_patch.launches.value == 1, snapshot_patch.launches.value
np.testing.assert_array_equal(out.cpu().numpy(), variant["embed/table"])
print(f"device patch on {device}: {int((ma.patch.sel >= 0).sum())} of "
      f"{ma.patch.sel.shape[0]} chunks from the diff, "
      f"kernel launches {snapshot_patch.launches.value}")

# 6. First-principles model (Eq. 1): predicted cold-start on paper hardware.
sizes = reg.sizes("my-adapter", residual_init_s=1e-3)
for strategy in ("regular", "reap", "seuss", "snapfaas-", "snapfaas"):
    p = predict(strategy, sizes, PAPER_C220G5)
    print(f"model[{strategy:10s}] = {p.total*1e3:7.2f} ms  "
          f"(A={p.A*1e3:.2f} B={p.B*1e3:.2f} C={p.C*1e3:.2f} D={p.D*1e3:.2f})")
print(f"practical lower bound: {lower_bound(sizes, PAPER_C220G5)*1e3:.2f} ms")
