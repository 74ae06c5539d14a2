"""The port's process groups, meshes and placements over gloo ranks on the
CPU (``parallel.mesh.spawn``): ``shard_batch`` against the JAX package's
placement of the same batch on a CPU mesh, ``replicate``, the frames ↔ tokens
all-to-all with an uneven token split and the GroupNorm whose statistics
span the ranks (against the whole tensor), ``init_distributed``'s world of
one and its failed rendezvous, ``spawn``'s errors and deadline, the
tensor-parallel head gate against JAX ``tp_shardings`` (the cases of
``test_tensor_parallel.py``), the inference CLI under a process group, and
``dryrun_multichip(4)``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch import nn

import torch_parallel_ranks as ranks
from torch_port_helpers import set_torch_threads
from videomv_tpu.parallel import make_mesh as jmake_mesh
from videomv_tpu.parallel import shard_batch as jshard_batch
from videomv_tpu.parallel import tensor_parallel_mesh as jtensor_parallel_mesh
from videomv_tpu.parallel import tp_shardings as jtp_shardings
from videomv_tpu_torch.parallel import (
    frame_parallel_mesh,
    init_distributed,
    spawn,
    tp_shardings,
    world_size,
)
from videomv_tpu_torch.parallel.dryrun import dryrun_multichip

set_torch_threads()

DEADLINE_S = 120


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    rs = np.random.default_rng(5)
    batch = {"latents": rs.standard_normal((6, 4, 2, 3, 3)).astype(np.float32),
             "y_words": rs.standard_normal((6, 5, 8)).astype(np.float32)}
    # 6 frames of 4 × 4 tokens: 16 tokens over 3 ranks split 6 / 5 / 5
    x = (rs.standard_normal((2, 4, 6, 4, 4)) * 2 + 1).astype(np.float32)
    tmp = tmp_path_factory.mktemp("rdv")
    got = {n: spawn(ranks.mesh_checks, n, init_file=str(tmp / f"w{n}"), deadline_s=DEADLINE_S,
                    args=(batch, x, 16)) for n in (2, 3)}
    return batch, got


@pytest.mark.parametrize("n", [2, 3])
def test_shard_batch_matches_jax_placement(checks, n):
    batch, got = checks
    mesh = jmake_mesh(n)
    for k, v in batch.items():
        placed = jshard_batch(mesh, {k: jnp.asarray(v)})[k]
        by_device = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
        for r, d in enumerate(mesh.devices.flat):
            np.testing.assert_array_equal(got[n][r]["rows"][k], by_device[d.id])
    assert all("does not divide over" in r["indivisible"] for r in got[n])


@pytest.mark.parametrize("n", [2, 3])
def test_replicate_and_collectives(checks, n):
    _, got = checks
    for r in got[n]:
        np.testing.assert_array_equal(r["replicated"], np.zeros(3))
        assert r["tokens_exact"] and r["round_trip_exact"]
        assert r["group_norm_err"] < 1e-5
    assert got[3][0]["token_counts"] == [6, 5, 5]


def test_one_process_is_a_world_of_one(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed(torch.device("cpu")) == 0
    assert not torch.distributed.is_initialized() and world_size() == 1
    assert frame_parallel_mesh(24) is None


def test_failed_rendezvous_raises(tmp_path):
    """A world of 2 whose second rank never comes: the rendezvous raises at
    its timeout; nothing falls back to one process."""
    with pytest.raises(RuntimeError):
        init_distributed(torch.device("cpu"), f"file://{tmp_path}/rdv", 0, 2, timeout_s=3)
    assert not torch.distributed.is_initialized()


def test_spawn_raises_a_ranks_error_and_its_deadline(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(ranks.failer, 2, init_file=str(tmp_path / "a"), deadline_s=DEADLINE_S)
    with pytest.raises(TimeoutError):
        spawn(ranks.sleeper, 2, init_file=str(tmp_path / "b"), deadline_s=8, args=(600,))
    with pytest.raises(ValueError, match="fresh rendezvous"):
        spawn(ranks.failer, 2, init_file=str(tmp_path / "a"))


class _Attention(nn.Module):
    """An attention module's projections (``[out, in]`` weights), as
    ``place_params_tp`` finds them."""

    def __init__(self, q, k, out):
        super().__init__()
        self.heads = 1
        self.to_q, self.to_k, self.to_v = nn.Linear(64, q), nn.Linear(64, k), nn.Linear(64, k)
        self.to_out = nn.Sequential(nn.Linear(out, 64))


@pytest.mark.parametrize("head_dim", [16, None])
def test_head_gate_matches_jax(head_dim):
    """5 heads of 16 fail the 2-way gate, 4 pass; without a head dim the
    gate is raw divisibility (test_tensor_parallel.py)."""
    hd = 16
    port = tp_shardings(nn.ModuleDict({"blk": _Attention(5 * hd, 4 * hd, 5 * hd)}), 2,
                        head_dim=head_dim)
    tree = {"blk": {"to_q": {"kernel": jnp.zeros((64, 5 * hd))},
                    "to_k": {"kernel": jnp.zeros((64, 4 * hd))},
                    "to_out_0": {"kernel": jnp.zeros((5 * hd, 64))}}}
    specs = jtp_shardings(tree, jtensor_parallel_mesh(num_heads=2), head_dim=head_dim)
    name = {P(): "replicated", P(None, "tp"): "column", P("tp", None): "row"}
    for leaf, key in (("to_q", "blk.to_q.weight"), ("to_k", "blk.to_k.weight"),
                      ("to_out_0", "blk.to_out.0.weight")):
        assert port[key] == name[specs["blk"][leaf]["kernel"].spec], key
    assert port["blk.to_k.weight"] == "column"
    assert port["blk.to_q.weight"] == ("replicated" if head_dim else "column")


def test_mid_head_gate_requires_exact_head_multiple():
    """160 features at head_dim 64 floor to 2 heads but split mid-head."""
    port = tp_shardings(nn.ModuleDict({"blk": _Attention(160, 160, 160)}), 2, head_dim=64)
    spec = jtp_shardings({"blk": {"to_q": {"kernel": jnp.zeros((64, 160))}}},
                         jtensor_parallel_mesh(num_heads=2), head_dim=64)
    assert spec["blk"]["to_q"]["kernel"].spec == P()
    assert port["blk.to_q.weight"] == "replicated"


def test_inference_cli_frame_parallel_at_two_ranks(tmp_path):
    """``torchrun -m videomv_tpu_torch.inference ... frame_parallel True``:
    both ranks serve the sample, rank 0 writes it."""
    res = spawn(ranks.inference_cli, 2, init_file=str(tmp_path / "rdv"), deadline_s=DEADLINE_S,
                args=(str(tmp_path / "out"),))
    assert len(res[0]["written"]) == 1 and res[0]["exists"] == [True]
    assert res[1]["written"] == []


def test_dryrun_multichip_four_ranks(capsys):
    res = dryrun_multichip(4)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): ok, loss=")
    assert "sp fwd" in line and "sp2×tp2 fwd" in line
    assert res["sp"][0] == 4 and res["sp"][1] < 2e-4 and res["sptp"][2] < 2e-4
    assert max(abs(a - b) for a, b in zip(res["loss"], res["fsdp"])) < 2e-4
