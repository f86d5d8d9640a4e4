"""repro_torch's multi-device paths on the CPU: the device mesh, the
``torch.distributed`` init hook, and ``dist.shard_refine``'s three
factories against the reference's ``shard_map`` forms on its (1,1) mesh
and its single-device solves — bitwise for the refine (dist and
parents), the update scatter and the int8 all-reduce — over 1, 2 and 3
logical CPU shards, inside ``grouped_ksp``, and across two gloo
processes."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data.roadnet import grid_road_network as jax_grid
from repro.core.dtlp import DTLP as JaxDTLP
from repro.dist.grouped_yen import grouped_ksp as jax_grouped_ksp
from repro.dist.shard_refine import make_allreduce_fn as jax_allreduce_fn
from repro.dist.shard_refine import make_refine_fn as jax_refine_fn
from repro.dist.shard_refine import make_update_fn as jax_update_fn
from repro.engine import dense as jax_dense
from repro.engine import layout as jax_layout
from repro.engine.backend import JnpBackend, PallasBackend
from repro.launch import mesh as jax_mesh
from repro_torch.core.dtlp import DTLP
from repro_torch.dist.grouped_yen import grouped_ksp
from repro_torch.dist.shard_refine import (make_allreduce_fn, make_refine_fn,
                                          make_update_fn, shard_count)
from repro_torch.engine import dense
from repro_torch.engine.backend import CudaBackend, TorchBackend
from repro_torch.engine.registry import get_engine
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh, make_mesh
from tests.test_torch_engine import _port_graph

ROOT = Path(__file__).resolve().parent.parent
INF = dense.INF
AXES = ("data", "model")

# the reference backend each port backend is held to
_TWINS = [(TorchBackend(), JnpBackend()),
          (CudaBackend(), PallasBackend(interpret=True))]
_TWIN_IDS = ["torch-jnp", "cuda-pallas"]


@pytest.fixture(scope="module")
def jax_mesh11():
    return jax.make_mesh((1, 1), AXES)


def cpu_mesh(n):
    return make_host_mesh(n, device="cpu")


# ---------------------------------------------------------------------------
# problems (the reference's, from tests/test_shard_refine.py, at S = 6 so
# that 1, 2 and 3 shards divide it)
# ---------------------------------------------------------------------------
def unmasked_problem():
    rng = np.random.default_rng(0)
    S, J, z = 6, 2, 16
    adj = rng.uniform(1, 9, (S, z, z)).astype(np.float32)
    adj[rng.random((S, z, z)) > 0.4] = INF
    for s in range(S):
        np.fill_diagonal(adj[s], 0.0)
    dist0 = np.full((S, J, z), INF, np.float32)
    dist0[:, :, 0] = 0.0
    no = np.zeros((S, J, z), bool)
    cap = np.full((S, J), INF, np.float32)
    return adj, dist0, no, no, no, cap


def masked_problem():
    rng = np.random.default_rng(3)
    S, J, z = 6, 3, 16
    adj = rng.uniform(1, 9, (S, z, z)).astype(np.float32)
    adj[rng.random((S, z, z)) > 0.4] = INF
    for s in range(S):
        np.fill_diagonal(adj[s], 0.0)
    init = np.full((S, J, z), INF, np.float32)
    bv = rng.random((S, J, z)) < 0.08
    so = np.zeros((S, J, z), bool)
    bn = rng.random((S, J, z)) < 0.05
    cap = np.full((S, J), INF, np.float32)
    cap[0] = rng.uniform(10.0, 30.0, J).astype(np.float32)  # a binding cap
    for s in range(S):
        for j in range(J):
            src = int(rng.integers(z))
            init[s, j, src] = 0.0
            so[s, j, src] = True
            bv[s, j, src] = False
    return adj, init, bv, so, bn, cap


def uneven_problem(S=6):
    """Rows converging at very different iteration counts: every row is
    edgeless (a fixed point after one step) but the last, a chain 0→1→…
    →z-1 that needs about z steps, on the last shard at any count."""
    J, z = 2, 16
    adj = np.full((S, z, z), INF, np.float32)
    for s in range(S):
        np.fill_diagonal(adj[s], 0.0)
    for v in range(z - 1):
        adj[S - 1, v, v + 1] = 1.0
    init = np.full((S, J, z), INF, np.float32)
    init[:, :, 0] = 0.0
    so = np.zeros((S, J, z), bool)
    so[:, :, 0] = True
    no = np.zeros((S, J, z), bool)
    cap = np.full((S, J), INF, np.float32)
    return adj, init, no, so, no, cap


_PROBLEMS = {"unmasked": unmasked_problem, "masked": masked_problem,
             "uneven": uneven_problem}


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
class TestMesh:
    def test_host_mesh_shapes(self):
        m = cpu_mesh(3)
        assert m.shape == {"data": 3, "model": 1} and m.size == 3
        assert m.axis_names == AXES and m.devices == (torch.device("cpu"),) * 3
        assert (m.rank, m.n_processes, m.first_shard) == (0, 1, 0)
        assert cpu_mesh(None).size == 1
        m = make_mesh((2, 2), AXES, device="cpu")
        assert m.shape == {"data": 2, "model": 2} and m.size == 4
        assert make_host_mesh(device=["cpu", "cpu"]).size == 2

    def test_bad_meshes_raise(self):
        with pytest.raises(ValueError, match="out of range"):
            cpu_mesh(0)
        with pytest.raises(ValueError, match="does not hold"):
            DeviceMesh(["cpu"] * 2, shape=(3, 1))
        with pytest.raises(ValueError, match="spans 2 of"):
            make_refine_fn(make_mesh((2, 2), AXES, device="cpu"),
                           axis="data")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                make_host_mesh()

    def test_init_distributed_environment_as_the_reference(self,
                                                           monkeypatch):
        """Explicit arguments first, then REPRO_COORDINATOR /
        REPRO_NUM_PROCESSES / REPRO_PROCESS_ID / REPRO_DISTRIBUTED_AUTO,
        as ``repro.launch.mesh.init_distributed`` reads them; False when
        nothing is configured.  The reference's coordinator, process
        count and id become the init method, world size and rank."""
        import torch.distributed as dist

        jax_calls, port_calls = [], []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: jax_calls.append(kw))
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: port_calls.append(
                                (backend, kw)))
        for var in ("REPRO_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                    "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID",
                    "REPRO_DISTRIBUTED_AUTO"):
            monkeypatch.delenv(var, raising=False)
        assert not jax_mesh.init_distributed()
        assert not port_mesh.init_distributed(device="cpu")
        cases = [
            ({"REPRO_COORDINATOR": "host:1234", "REPRO_NUM_PROCESSES": "4",
              "REPRO_PROCESS_ID": "2"}, {}),
            ({"REPRO_COORDINATOR": "host:1234"}, {}),
            ({"REPRO_COORDINATOR": "host:1234", "REPRO_NUM_PROCESSES": "4",
              "REPRO_PROCESS_ID": "2"},
             {"coordinator_address": "other:99", "num_processes": 2,
              "process_id": 0}),
            ({"REPRO_DISTRIBUTED_AUTO": "1"}, {}),
        ]
        for env, kw in cases:
            for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                        "REPRO_PROCESS_ID", "REPRO_DISTRIBUTED_AUTO"):
                monkeypatch.delenv(var, raising=False)
            for var, val in env.items():
                monkeypatch.setenv(var, val)
            assert jax_mesh.init_distributed(**kw)
            assert port_mesh.init_distributed(**kw, device="cpu")
            want = jax_calls[-1]
            backend, got = port_calls[-1]
            assert backend == "gloo"
            assert got.get("world_size") == want.get("num_processes")
            assert got.get("rank") == want.get("process_id")
            coord = want.get("coordinator_address")
            assert got["init_method"] == (f"tcp://{coord}" if coord
                                          else "env://")


# ---------------------------------------------------------------------------
# make_refine_fn
# ---------------------------------------------------------------------------
class TestRefine:
    @pytest.mark.parametrize("problem", sorted(_PROBLEMS))
    @pytest.mark.parametrize("twins", _TWINS, ids=_TWIN_IDS)
    def test_one_shard_equals_reference(self, twins, problem, jax_mesh11):
        """On one shard the port's refine gives the bytes of repro's
        refine on its (1,1) mesh (with the jnp body: the installed jax's
        shard_map refuses the Pallas call's output spec) and of the twin
        backend's single-device solve."""
        port, ref_backend = twins
        args = _PROBLEMS[problem]()
        jargs = [jnp.asarray(a) for a in args]
        jd, jp = jax_refine_fn(jax_mesh11, backend=JnpBackend())(*jargs)
        sd, sp = ref_backend.solve_grouped(*jargs)
        d, p = make_refine_fn(cpu_mesh(1), backend=port)(*_t(args))
        for want_d, want_p in ((jd, jp), (sd, sp)):
            np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
            np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))

    @pytest.mark.parametrize("n_shards", [2, 3])
    @pytest.mark.parametrize("problem", sorted(_PROBLEMS))
    @pytest.mark.parametrize("twins", _TWINS, ids=_TWIN_IDS)
    def test_shards_equal_single_device_solve(self, twins, problem,
                                              n_shards):
        """Over 2 and 3 logical shards the refine lands on the bytes of
        repro's single-device solve (the port's too), the uneven case
        included: each shard's solve runs until its own rows converge,
        the chain's shard longest."""
        port, ref_backend = twins
        args = _PROBLEMS[problem]()
        sd, sp = ref_backend.solve_grouped(*(jnp.asarray(a) for a in args))
        d, p = make_refine_fn(cpu_mesh(n_shards), backend=port)(*_t(args))
        np.testing.assert_array_equal(d.numpy(), np.asarray(sd))
        np.testing.assert_array_equal(p.numpy(), np.asarray(sp))
        pd, pp = port.solve_grouped(*_t(args))
        assert torch.equal(d, pd) and torch.equal(p, pp)
        if problem == "uneven":  # the chain propagated end to end
            assert float(d[-1, 0, -1]) == 15.0

    def test_uneven_two_rows_as_the_reference(self):
        """The reference's own uneven case (S = 2, one row per shard)."""
        args = uneven_problem(S=2)
        sd, sp = JnpBackend().solve_grouped(*(jnp.asarray(a) for a in args))
        d, p = make_refine_fn(cpu_mesh(2))(*_t(args))
        np.testing.assert_array_equal(d.numpy(), np.asarray(sd))
        np.testing.assert_array_equal(p.numpy(), np.asarray(sp))

    @pytest.mark.parametrize("backend", [TorchBackend, CudaBackend],
                             ids=["dense_bf", "cuda_bf"])
    def test_each_shard_solves_its_rows_once(self, backend):
        """Over 2 and 3 shards the mesh solve calls the backend's
        ``solve_grouped`` once per shard, on that shard's rows of every
        input, and its result is the single-device solve, bit for bit."""
        calls = []

        class Recording(backend):
            def solve_grouped(self, *args):
                calls.append(args)
                return super().solve_grouped(*args)

        args = _t(masked_problem())
        want_d, want_p = backend().solve_grouped(*args)
        for n in (2, 3):
            calls.clear()
            d, p = make_refine_fn(cpu_mesh(n), backend=Recording())(*args)
            assert torch.equal(d, want_d) and torch.equal(p, want_p)
            rows = args[0].shape[0] // n
            assert len(calls) == n
            for g, got in enumerate(calls):
                assert all(torch.equal(a, t[g * rows:(g + 1) * rows])
                           for a, t in zip(got, args))

    def test_rows_must_divide(self):
        with pytest.raises(ValueError, match="multiple"):
            make_refine_fn(cpu_mesh(4))(*_t(masked_problem()))

    @pytest.mark.parametrize("engine", ["cuda_bf", "dense_bf"])
    def test_mesh_solver_inside_grouped_ksp(self, engine):
        """The engine's mesh solver on 2 shards, with rounds padded to a
        multiple of 2 and gathered from a split slab copy, serves
        repro's dense_bf paths, bitwise."""
        jg = jax_grid(6, 6, seed=1)
        jd = JaxDTLP.build(jg, z=12, xi=4)
        d = DTLP.build(_port_graph(jg), z=12, xi=4)
        spec = get_engine(engine)
        jslab = jax_dense.pack_subgraphs(jd.partition, jg.w,
                                         layout=jax_layout.JNP_LAYOUT)
        slab = dense.pack_subgraphs(d.partition, d.graph.w,
                                    layout=spec.layout)
        tasks = []
        for row in range(min(3, slab.n_sub)):
            sg = d.partition.subgraphs[int(slab.gids[row])]
            tasks += [(row, 0, sg.nv - 1), (row, 1, sg.nv - 2)]
        want = jax_grouped_ksp(jslab.adj, tasks, 3, backend=JnpBackend())
        mesh = cpu_mesh(2)
        solver = make_refine_fn(mesh, AXES, backend=spec.backend)
        s_multiple = shard_count(mesh, AXES)
        assert s_multiple == 2
        dense.place_slab(slab, "cpu", shards=mesh.devices,
                         s_multiple=s_multiple)
        got = grouped_ksp(
            slab.adj, tasks, 3, solver=solver, s_multiple=s_multiple,
            backend=spec.backend, device="cpu",
            gather=lambda rows: dense.gather_slab_rows(slab, rows))
        assert got == want


# ---------------------------------------------------------------------------
# the split slab copy and make_update_fn
# ---------------------------------------------------------------------------
class TestSlabCopy:
    def test_place_gather_pads_like_the_reference(self):
        """S is padded to the shard multiple with copies of row 0; a
        gather reads the rows each shard holds."""
        rng = np.random.default_rng(1)
        adj = rng.uniform(1, 9, (5, 8, 8)).astype(np.float32)
        slab = dense.SubgraphSlab(adj=adj, nv=np.full(5, 8, np.int32),
                                  gids=np.arange(5), z=8)
        dense.place_slab(slab, "cpu", shards=[torch.device("cpu")] * 3,
                         s_multiple=3)
        mirror = slab.adj_dev
        assert isinstance(mirror, dense.ShardedMirror)
        assert mirror.shape == (6, 8, 8) and mirror.rows == 2
        np.testing.assert_array_equal(mirror.full().numpy()[:5], adj)
        np.testing.assert_array_equal(mirror.full().numpy()[5], adj[0])
        rows = np.array([4, 0, 3, 1, 2, 4], np.int32)
        np.testing.assert_array_equal(
            dense.gather_slab_rows(slab, rows).numpy(), adj[rows])
        dense.place_slab(slab, "cpu", shards=[torch.device("cpu")])
        assert isinstance(slab.adj_dev, torch.Tensor)  # one shard: one tensor

    @pytest.mark.parametrize("n_shards", [1, 2])
    def test_update_equals_reference(self, n_shards, jax_mesh11):
        """Each shard applies the rows it holds, -1 padding is dropped,
        and the copy it was given is never written: bitwise repro's
        (1,1) scatter, on a split copy and on one tensor."""
        rng = np.random.default_rng(2)
        S, z = 4, 8
        adj = rng.uniform(1, 9, (S, z, z)).astype(np.float32)
        slab_idx = np.array([0, 1, 2, 3, -1, -1], np.int32)
        uu = np.array([1, 2, 3, 4, 0, 5], np.int32)
        vv = np.array([5, 6, 7, 0, 0, 5], np.int32)
        ww = np.array([1.5, 2.5, 3.5, 4.5, 99.0, 98.0], np.float32)
        want = np.asarray(jax_update_fn(jax_mesh11)(
            jnp.asarray(adj), *map(jnp.asarray, (slab_idx, uu, vv, ww))))
        mesh = cpu_mesh(n_shards)
        update = make_update_fn(mesh)
        slab = dense.SubgraphSlab(adj=adj.copy(), nv=np.full(S, z, np.int32),
                                  gids=np.arange(S), z=z)
        dense.place_slab(slab, "cpu", shards=mesh.devices,
                         s_multiple=n_shards)
        old = slab.adj_dev
        got = update(old, slab_idx, uu, vv, ww)
        full = got.full() if n_shards > 1 else got
        np.testing.assert_array_equal(full.numpy(), want)
        before = old.full() if n_shards > 1 else old
        np.testing.assert_array_equal(before.numpy(), adj)  # untouched
        plain = update(torch.from_numpy(adj), slab_idx, uu, vv, ww)
        np.testing.assert_array_equal(plain.numpy(), want)
        routed = dense.scatter_slab_cells(old, slab_idx, uu, vv, ww,
                                          update_fn=update)
        full = routed.full() if n_shards > 1 else routed
        np.testing.assert_array_equal(full.numpy(), want)


# ---------------------------------------------------------------------------
# make_allreduce_fn
# ---------------------------------------------------------------------------
class TestAllReduce:
    @pytest.mark.parametrize("compressed", [True, False])
    def test_one_shard_equals_reference(self, compressed, jax_mesh11):
        """Three calls, the residual carried: bitwise repro's (1,1)."""
        rng = np.random.default_rng(4)
        ar = make_allreduce_fn(cpu_mesh(1), compressed=compressed)
        jar = jax_allreduce_fn(jax_mesh11, compressed=compressed)
        resid = torch.zeros(37)
        jresid = jnp.zeros(37, jnp.float32)
        for _ in range(3):
            x = rng.normal(0, 3, 37).astype(np.float32)
            x[5] = 0.5 * (x.max() / 127)  # a tie for round-half-even
            avg, resid = ar(torch.from_numpy(x), resid)
            javg, jresid = jar(jnp.asarray(x), jresid)
            np.testing.assert_array_equal(avg.numpy(), np.asarray(javg))
            np.testing.assert_array_equal(resid.numpy(), np.asarray(jresid))

    @pytest.mark.parametrize("compressed", [True, False])
    def test_two_shards_equal_the_formula(self, compressed):
        rng = np.random.default_rng(5)
        x = rng.normal(0, 3, 50).astype(np.float32)
        r = rng.normal(0, 0.01, 50).astype(np.float32)
        avg, resid = make_allreduce_fn(cpu_mesh(2), compressed=compressed)(
            torch.from_numpy(x), torch.from_numpy(r))
        if compressed:
            y = x + r
            scale = np.maximum(np.abs(y).max() / np.float32(127),
                               np.float32(1e-30))
            deq = np.clip(np.round(y / scale), -127, 127).astype(
                np.int8).astype(np.float32) * scale
            q = np.rint(deq / scale)
            want, want_r = (deq + deq) / np.float32(2), (
                y.astype(np.float64) - q * np.float64(scale)).astype(np.float32)
        else:
            want, want_r = (x + x) / np.float32(2), np.zeros_like(x)
        np.testing.assert_array_equal(avg.numpy(), want)
        np.testing.assert_array_equal(resid.numpy(), want_r)


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------
_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist.shard_refine import make_allreduce_fn, make_refine_fn
from repro_torch.engine.backend import CudaBackend
from repro_torch.launch.mesh import init_distributed, make_host_mesh

out = sys.argv[1]
assert init_distributed(device="cpu")
rank = dist.get_rank()
data = np.load(os.path.join(out, "inputs.npz"))
args = [torch.from_numpy(data[k]) for k in
        ("adj", "init", "bv", "so", "bn", "cap")]
seen = []


class Recording(CudaBackend):
    def solve_grouped(self, adj, *rest):
        seen.append(adj.clone())
        return super().solve_grouped(adj, *rest)


mesh = make_host_mesh(device="cpu")
d, p = make_refine_fn(mesh, backend=Recording())(*args)
x = torch.from_numpy(data["x"][rank])
avg, resid = make_allreduce_fn(mesh)(x, torch.zeros_like(x))
np.savez(os.path.join(out, f"out{rank}.npz"), dist=d.numpy(),
         parent=p.numpy(), seen=torch.stack(seen).numpy(), avg=avg.numpy(),
         resid=resid.numpy(), shape=np.array([mesh.size, mesh.first_shard]))
dist.destroy_process_group()
"""


def test_two_gloo_processes(tmp_path):
    """Two processes, one shard each, joined by gloo through a FileStore:
    each solves only its own row block, exactly once, and the gathered
    result is bitwise the one-process result; the compressed all-reduce
    averages both processes' vectors.  Joined with a timeout: a hang
    fails."""
    args = masked_problem()
    rng = np.random.default_rng(6)
    xs = rng.normal(0, 2, (2, 40)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", adj=args[0], init=args[1], bv=args[2],
             so=args[3], bn=args[4], cap=args[5], x=xs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_COORDINATOR=f"file://{tmp_path / 'store'}",
               REPRO_NUM_PROCESSES="2", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp_path)],
        env=dict(env, REPRO_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=60)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    assert [pr.returncode for pr in procs] == [0, 0], logs
    want_d, want_p = make_refine_fn(cpu_mesh(1), backend=CudaBackend())(
        *_t(args))
    rows = args[0].shape[0] // 2
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for r, out in enumerate(outs):
        assert out["shape"].tolist() == [2, r]
        np.testing.assert_array_equal(out["dist"], want_d.numpy())
        np.testing.assert_array_equal(out["parent"], want_p.numpy())
        block = args[0][r * rows:(r + 1) * rows]
        assert len(out["seen"]) == 1
        np.testing.assert_array_equal(out["seen"][0], block)

    def quantize(y):
        scale = np.maximum(np.abs(y).max() / np.float32(127),
                           np.float32(1e-30))
        q = np.clip(np.round(y / scale), -127, 127).astype(np.int8)
        resid = y.astype(np.float64) - q * np.float64(scale)
        return q.astype(np.float32) * scale, resid.astype(np.float32)

    want_avg = (quantize(xs[0])[0] + quantize(xs[1])[0]) / np.float32(2)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["avg"], want_avg)
        np.testing.assert_array_equal(out["resid"], quantize(xs[r])[1])
