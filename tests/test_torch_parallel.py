"""The multi-GPU layer of the port against the JAX package's, on the CPU.

The pattern-sharded lookup (``ShardedStreamLookup`` over ``LocalShards``,
the plain versions) against JAX's ``_attn_ln_stream_tp`` under
``shard_map`` on ``(1, 2)`` and ``(1, 4)`` meshes of the suite's 8 CPU
devices and its unsharded ``_attn_ln_stream``, both in Pallas interpret
mode; the batch bounds against JAX's batch sharding; and the trainer in
two gloo processes at ``(n_data, n_model)`` of ``(2, 1)`` and ``(1, 2)``
against the single-process port.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from hopvae_tpu.ops import hopfield_pallas as hp
from hopvae_tpu.parallel import mesh as jax_mesh
from hopvae_torch.ops import hopfield_cuda as hc
from hopvae_torch.parallel import mesh as mesh_lib
from torch_parallel_worker import TINY, Recording, tiny_setup

HERE = Path(__file__).resolve().parent
RTOL, ATOL = 2e-5, 1e-6  # JAX's own in test_pallas_pattern_sharded_matches_single_device
N, M, D_IN, D_OUT = 40, 96, 16, 8


def _inputs():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(N, D_IN), f(M, D_IN), f(M, D_OUT), 1 + 0.1 * f(D_IN), 0.1 * f(D_IN), f(N, D_OUT)


@pytest.fixture(scope="module")
def jax_lookups():
    """JAX's output and five gradients: unsharded, then sharded over 2 and 4
    devices of the model axis."""
    x, k, u, s, t, g = map(jnp.asarray, _inputs())
    hi = jax.lax.Precision.HIGHEST
    out = {}
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(jax.jit(lambda *a: hp._attn_ln_stream(*a, hi)), x, k, u, s, t)
        out[1] = [np.asarray(a) for a in (y, *vjp(g))]
        for n in (2, 4):
            mesh = jax_mesh.make_mesh(n_data=1, n_model=n, devices=jax.devices()[:n])
            fn = jax.shard_map(lambda *a: hp._attn_ln_stream_tp(*a, hi, "model"), mesh=mesh,
                               in_specs=(P(), P("model"), P("model"), P(), P()), out_specs=P(), check_vma=False)
            y, vjp = jax.vjp(jax.jit(fn), x, k, u, s, t)
            out[n] = [np.asarray(a) for a in (y, *vjp(g))]
    return out


def _ours(n_shards, scale=1.0):
    x, k, u, s, t, g = map(torch.from_numpy, _inputs())
    leaves = [a.clone().requires_grad_() for a in (x, k, u, s, t)]
    y = hc.ShardedStreamLookup.apply(*leaves, hc.LocalShards(n_shards))
    y.backward(g * scale)
    return [y.detach().numpy()] + [a.grad.numpy() for a in leaves]


def _close(ours, theirs) -> bool:
    return all(np.allclose(a, b, rtol=RTOL, atol=ATOL) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_lookup_matches_jax(jax_lookups, n_shards):
    """Forward and the gradients of x, K, U, s and t within JAX's tolerance
    of JAX's sharded lookup and of its unsharded one; the cotangent scaled
    by the shard count, as a copy of JAX's ``psum`` of it would do, misses."""
    ours = _ours(n_shards)
    for want in (jax_lookups[n_shards], jax_lookups[1]):
        for name, a, b in zip(("out", "dx", "dK", "dU", "ds", "dt"), ours, want):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    assert not _close(_ours(n_shards, scale=n_shards), jax_lookups[n_shards])


def test_patterns_that_do_not_split_raise():
    k = torch.zeros(M, D_IN)
    with pytest.raises(ValueError, match="do not split"):
        hc.LocalShards(5).split(k)
    with pytest.raises(ValueError, match="do not split"):
        mesh_lib.pattern_rows(mesh_lib.Mesh(1, 5, 0, None, None), M)
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.process_batch_bounds(mesh_lib.Mesh(3, 1, 0, None, None), 8)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2), (2, 2)])
def test_batch_bounds_match_jax_sharding(n_data, n_model):
    """Rank ``r`` trains on the slice of the global batch that JAX's batch
    sharding gives the device at ``(r // n_model, r % n_model)`` of its
    mesh, and holds the rows of the patterns that JAX's pattern sharding
    gives it."""
    mesh = jax_mesh.make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[: n_data * n_model])
    batches = NamedSharding(mesh, P("data")).devices_indices_map((16,))
    rows = NamedSharding(mesh, P("model", None)).devices_indices_map((M, D_IN))
    for r in range(n_data * n_model):
        ours = mesh_lib.Mesh(n_data, n_model, r, None, None)
        device = mesh.devices[r // n_model, r % n_model]
        (want,) = batches[device]
        assert slice(*mesh_lib.process_batch_bounds(ours, 16)) == slice(want.start or 0, want.stop or 16)
        want_rows = rows[device][0]
        assert mesh_lib.pattern_rows(ours, M) == slice(want_rows.start or 0, want_rows.stop or M)


@pytest.fixture(scope="module")
def single_process(tmp_path_factory):
    """The single-process port on the same data: its two losses, its
    patterns after the two steps and its test error."""
    cfg, model, train, test = tiny_setup()
    tr = Recording(model, cfg)
    tr.losses, tr.watch_gradients = [], True
    out = tmp_path_factory.mktemp("single")
    tr.fit(train, test, epochs=1, eval_every=0, save_every=0, out_dir=str(out))
    return tr.losses, {k: v.clone() for k, v in model.state_dict().items() if k.endswith("lookup_weights")}, \
        tr.evaluate(test), _train_record(out)


def _train_record(out: Path) -> dict:
    return next(json.loads(line) for line in open(out / "metrics.jsonl") if "Train Reconstruction Error" in line)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)])
def test_two_gloo_processes_match_one(tmp_path, single_process, n_data, n_model):
    """Two ranks at ``(2, 1)`` (data parallel) or ``(1, 2)`` (the patterns
    split): two Adam steps whose losses and patterns are within JAX's
    tolerance of the single-process port's, the ranks agreeing bit for
    bit; the watched gradient norms within that tolerance, each histogram
    counting its module's full parameters; only rank 0 writes grids, the
    record and the checkpoint, which holds all 96 patterns and their Adam
    moments."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_parallel_worker.py"), str(r), "2", str(port),
                               str(n_model), str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    losses, patterns, test_err, record = single_process
    assert ranks[0]["losses"] == ranks[1]["losses"] and ranks[0]["test_err"] == ranks[1]["test_err"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ranks[0]["test_err"], test_err, rtol=RTOL, atol=ATOL)
    assert [r["local_rows"] for r in ranks] == [TINY["num_embeddings"] // n_model] * 2
    for name, want in patterns.items():
        assert torch.equal(ranks[0]["patterns"][name], ranks[1]["patterns"][name]), name
        np.testing.assert_allclose(ranks[0]["patterns"][name], want, rtol=RTOL, atol=ATOL, err_msg=name)
    watched = _train_record(tmp_path)
    model = tiny_setup()[1]
    for k, mod in model.named_children():
        size = sum(p.numel() for p in mod.parameters())
        if size:
            np.testing.assert_allclose(watched[f"grad_norm/{k}"], record[f"grad_norm/{k}"], rtol=RTOL, atol=ATOL)
            assert sum(watched[f"grad_hist/{k}"]) == 2 * size and watched[f"param_hist/{k}"] is not None
    assert len([line for line in open(tmp_path / "metrics.jsonl") if "Train Reconstruction Error" in line]) == 1
    assert ranks[0]["writes"]["grids"] > 0 and ranks[0]["writes"]["checkpoints"] == 1
    assert ranks[1]["writes"] == {"grids": 0, "checkpoints": 0}
    ckpt = torch.load(tmp_path / "MNIST-28.pt")
    for name in patterns:
        assert torch.equal(ckpt["model"][name], ranks[0]["patterns"][name])
    m = TINY["num_embeddings"]
    assert len([s for s in ckpt["optimizer"]["state"].values() if s["exp_avg"].shape[0] == m]) == 3
