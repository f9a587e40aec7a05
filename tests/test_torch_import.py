"""The port and ``chip_smoke.py`` never import JAX, and the smoke script
refuses to run without a CUDA device."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(code: str, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_smoke_script_do_not_import_jax():
    code = (
        "import sys\n"
        "import conjugategradient_tpu_torch\n"
        "import conjugategradient_tpu_torch.convert\n"
        "import conjugategradient_tpu_torch.precond.multigrid\n"
        "import conjugategradient_tpu_torch.precond.amg\n"
        "import conjugategradient_tpu_torch.precond.block_jacobi\n"
        "import conjugategradient_tpu_torch.ops.cuda_stencil\n"
        "import conjugategradient_tpu_torch.ops.cuda_dia\n"
        "import conjugategradient_tpu_torch.ops.spmm\n"
        "import conjugategradient_tpu_torch.solvers.multi\n"
        "import conjugategradient_tpu_torch.solvers.refine\n"
        "import conjugategradient_tpu_torch.solvers.bicgstab\n"
        "import conjugategradient_tpu_torch.solvers.gmres\n"
        "import conjugategradient_tpu_torch.solvers.minres\n"
        "import conjugategradient_tpu_torch.solvers.idr\n"
        "import conjugategradient_tpu_torch.solvers.cheby\n"
        "import conjugategradient_tpu_torch.solvers.cgnr\n"
        "import conjugategradient_tpu_torch.solvers.lsmr\n"
        "import conjugategradient_tpu_torch.solvers.cacg\n"
        "import conjugategradient_tpu_torch.solvers.deflation\n"
        "import conjugategradient_tpu_torch.solvers.diff\n"
        "import conjugategradient_tpu_torch.solvers.lobpcg\n"
        "import conjugategradient_tpu_torch.solvers.arnoldi\n"
        "import conjugategradient_tpu_torch.scripts.inverse_demo\n"
        "import conjugategradient_tpu_torch.models.workloads\n"
        "import conjugategradient_tpu_torch.api\n"
        "import conjugategradient_tpu_torch.utils\n"
        "import conjugategradient_tpu_torch.scripts.reference_workloads\n"
        "import conjugategradient_tpu_torch.parallel.comm\n"
        "import conjugategradient_tpu_torch.parallel.multihost\n"
        "import conjugategradient_tpu_torch.scripts.multiprocess_demo\n"
        "import conjugategradient_tpu_torch.scripts.smoke_times\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "bad += sorted(m for m in sys.modules if m == 'conjugategradient_tpu' or m.startswith('conjugategradient_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    p = _run(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "clean"


def test_smoke_script_fails_without_cuda():
    # this machine has no CUDA device: non-zero exit, and no result line
    p = _run("import sys, chip_smoke; sys.exit(chip_smoke.main())")
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_smoke_script_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
