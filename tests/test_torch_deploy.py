"""The port's torchrun launcher (``deploy/torch_job.sh``) on the CPU: valid
shell; under ``DRY_RUN=1`` the command it builds, whose torchrun flags
torch's own launcher parses and whose trainer flags
``hopvae_torch/train.py`` defines, as ``tests/test_deploy.py`` checks the
TPU script."""

import os
import shlex
import subprocess

import pytest
from torch.distributed.run import get_args_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "deploy", "torch_job.sh")
TRAINER_FLAGS = ("--config", "--data", "--out", "--production")


def _dry_run(*args, **env) -> list:
    out = subprocess.run(["bash", SCRIPT, *args], env={**os.environ, "DRY_RUN": "1", **env},
                         capture_output=True, text=True, check=True).stdout
    return shlex.split(out)


def test_torch_job_script_is_valid_bash():
    subprocess.run(["bash", "-n", SCRIPT], check=True)
    assert "hopvae_torch.train" in open(SCRIPT).read()


def test_torch_job_dry_run_builds_the_torchrun_command():
    cmd = _dry_run("/data/mnist", "mnist_28", "--", "--epochs", "1", "--set", "batch_size=256")
    args = get_args_parser().parse_args(cmd[1:])
    assert cmd[0] == "torchrun" and args.standalone and args.nproc_per_node == "gpu"
    assert args.module and args.training_script == "hopvae_torch.train"
    assert args.training_script_args == ["--config", "mnist_28", "--data", "/data/mnist", "--out", "outputs/mnist_28",
                                         "--production", "--epochs", "1", "--set", "batch_size=256"]
    # every flag the wrapper passes must be a real trainer flag
    trainer_src = open(os.path.join(REPO, "hopvae_torch", "train.py")).read()
    for flag in TRAINER_FLAGS + ("--epochs", "--set"):
        assert flag in args.training_script_args, f"launcher no longer passes {flag}"
        assert f'"{flag}"' in trainer_src, f"trainer no longer accepts {flag}"


def test_torch_job_defaults_and_nproc():
    cmd = _dry_run("/data/ffhq", NPROC="2")
    args = get_args_parser().parse_args(cmd[1:])
    assert args.nproc_per_node == "2"
    assert args.training_script_args == ["--config", "ffhq_64", "--data", "/data/ffhq", "--out", "outputs/ffhq_64",
                                         "--production"]


def test_torch_job_many_nodes():
    cmd = _dry_run("/data/ffhq", "ffhq_64_scaled", NNODES="2", NODE_RANK="1", RDZV_ENDPOINT="node0:29400", NPROC="8")
    args = get_args_parser().parse_args(cmd[1:])
    assert not args.standalone and args.nnodes == "2" and args.node_rank == 1
    assert args.rdzv_endpoint == "node0:29400" and args.rdzv_backend == "static"
    assert args.training_script_args[:2] == ["--config", "ffhq_64_scaled"]


@pytest.mark.parametrize("missing", ["NODE_RANK", "RDZV_ENDPOINT"])
def test_torch_job_many_nodes_needs_its_rank_and_endpoint(missing):
    env = {k: v for k, v in {"NNODES": "2", "NODE_RANK": "0", "RDZV_ENDPOINT": "node0:29400"}.items() if k != missing}
    base = {k: v for k, v in os.environ.items() if k not in ("NODE_RANK", "RDZV_ENDPOINT")}
    proc = subprocess.run(["bash", SCRIPT, "/data/ffhq"], env={**base, "DRY_RUN": "1", **env}, capture_output=True,
                          text=True)
    assert proc.returncode != 0 and missing in proc.stderr and not proc.stdout


def test_torch_job_needs_a_data_path():
    proc = subprocess.run(["bash", SCRIPT], env={**os.environ, "DRY_RUN": "1"}, capture_output=True, text=True)
    assert proc.returncode != 0 and "usage" in proc.stderr
