"""One process of a workload CLI of the port, for
tests/test_torch_parallel_cli.py.

    python tests/torch_cli_worker.py MODULE [ARG ...]

Runs ``multimodal_segmentation_project_tpu_torch.workloads.MODULE``'s main
on ARG as ``python -m`` would (torchrun's environment, where the test sets
it, initialises ``torch.distributed``), with torch on the test workers'
threads (``tests/_torch_threads.py``), so that runs compare bit for bit.
After a trainer's run it prints ``PARAMS <rank> <sha256>`` of its model's
state_dict.
"""

import hashlib
import importlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_segmentation_project_tpu_torch.engine import trainer  # noqa: E402
from multimodal_segmentation_project_tpu_torch.parallel.mesh import rank  # noqa: E402
from tests import _torch_threads  # noqa: E402,F401  (torch's threads in the workers)

_run = trainer.Trainer.run


def _run_and_digest(self):
    summary = _run(self)
    digest = hashlib.sha256()
    for name, value in sorted(self.state.model.state_dict().items()):
        digest.update(name.encode())
        digest.update(value.detach().cpu().contiguous().numpy().tobytes())
    print(f"PARAMS {rank()} {digest.hexdigest()}", flush=True)
    return summary


if __name__ == "__main__":
    trainer.Trainer.run = _run_and_digest
    module = importlib.import_module(
        f"multimodal_segmentation_project_tpu_torch.workloads.{sys.argv[1]}")
    module.main(module.build_parser().parse_args(sys.argv[2:]))
