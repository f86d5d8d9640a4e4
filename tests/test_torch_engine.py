"""repro_torch engine and runtime layers vs the JAX reference on the CPU:
slab bytes, bucket geometry, the functional device scatter, backends,
grouped Yen and the device-resident worker slabs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.dtlp import DTLP as JaxDTLP
from repro.data.roadnet import grid_road_network as jax_grid
from repro.dist.grouped_yen import grouped_ksp as jax_grouped_ksp
from repro.engine import dense as jax_dense
from repro.engine import layout as jax_layout
from repro.engine.backend import JnpBackend
from repro_torch.convert import graph_from_numpy, slab_from_numpy
from repro_torch.core.dtlp import DTLP
from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
from repro_torch.dist.cluster import Cluster
from repro_torch.dist.grouped_yen import grouped_ksp
from repro_torch.engine import dense, layout
from repro_torch.engine.backend import (CudaBackend, SolverBackend,
                                        TorchBackend)
from repro_torch.engine.registry import available_engines, get_engine
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
from tests.test_backend import masked_slab

# the reference's geometry for each port layout (same lane/J rules)
_JAX_TWIN = {
    "plain-tight": jax_layout.JNP_LAYOUT,
    "hopper-cuda": jax_layout.SlabLayout(name="hopper-twin", lane=32,
                                         j_align=8, j_max=32),
}
_LAYOUTS = [layout.PLAIN_LAYOUT, layout.HOPPER_LAYOUT]


def _port_graph(g):
    return graph_from_numpy({"n": g.n, "edge_u": g.edge_u,
                             "edge_v": g.edge_v, "w": g.w,
                             "directed": g.directed})


@pytest.fixture(scope="module")
def port_dtlp(small_net):
    return DTLP.build(_port_graph(small_net), z=20, xi=4)


class TestPacking:
    @pytest.mark.parametrize("lay", _LAYOUTS, ids=lambda lay: lay.name)
    def test_slab_bytes_equal_reference(self, small_dtlp, port_dtlp, lay):
        """Same graph → same partition → same packed bytes, per layout."""
        want = jax_dense.pack_subgraphs(
            small_dtlp.partition, small_dtlp.graph.w,
            layout=_JAX_TWIN[lay.name])
        got = dense.pack_subgraphs(port_dtlp.partition, port_dtlp.graph.w,
                                   layout=lay)
        assert got.adj.tobytes() == want.adj.tobytes()
        np.testing.assert_array_equal(got.nv, want.nv)
        np.testing.assert_array_equal(got.gids, want.gids)
        assert got.z == want.z and got.z % lay.lane == 0

    def test_bare_lane_default_equals_reference(self, small_dtlp, port_dtlp):
        gids = [0, 2]
        want = jax_dense.pack_subgraphs(small_dtlp.partition,
                                        small_dtlp.graph.w, gids=gids)
        got = dense.pack_subgraphs(port_dtlp.partition, port_dtlp.graph.w,
                                   gids=gids)
        assert got.z == 128 and got.adj.tobytes() == want.adj.tobytes()

    @pytest.mark.parametrize("lay", _LAYOUTS, ids=lambda lay: lay.name)
    def test_bucket_shape_and_pack_round(self, lay):
        twin = _JAX_TWIN[lay.name]
        rng = np.random.default_rng(0)
        for _ in range(30):
            counts = [int(n) for n in
                      rng.integers(1, 40, size=rng.integers(1, 9))]
            for sm in (1, 2, 4):
                assert lay.bucket_shape(counts, sm) == \
                    twin.bucket_shape(counts, sm)
        z = 32
        adj = rng.uniform(1, 9, (5, z, z)).astype(np.float32)
        jobs = [(int(rng.integers(5)), int(rng.integers(z)),
                 rng.random(z) < 0.1, rng.random(z) < 0.1,
                 float(rng.uniform(10, 90))) for _ in range(23)]
        got, got_slots = lay.pack_round(adj, jobs)
        want, want_slots = twin.pack_round(adj, jobs)
        assert got_slots == want_slots
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_hopper_layout_geometry(self):
        assert layout.HOPPER_LAYOUT.align_z(79) == 96
        S, J = layout.HOPPER_LAYOUT.bucket_shape([100])
        assert J <= 32 and J % 8 == 0 and S * J >= 100


class TestDeviceSlab:
    def test_place_and_gather(self, port_dtlp):
        slab = dense.pack_subgraphs(port_dtlp.partition, port_dtlp.graph.w,
                                    layout=layout.HOPPER_LAYOUT)
        dense.place_slab(slab, "cpu")
        assert slab.adj_dev.data_ptr() != slab.adj.__array_interface__["data"][0]
        rows = np.array([2, 0, 2], np.int32)
        got = dense.gather_slab_rows(slab, rows)
        np.testing.assert_array_equal(got.numpy(), slab.adj[rows])

    def test_scatter_is_functional_and_drops_padding(self):
        rng = np.random.default_rng(2)
        adj = rng.uniform(1, 9, (3, 8, 8)).astype(np.float32)
        rows = np.array([2, 0, -1, -1], np.int32)
        uu = np.array([1, 3, 5, 6], np.int32)
        vv = np.array([4, 0, 5, 6], np.int32)
        ww = np.array([0.5, 0.25, 99.0, 98.0], np.float32)
        old = torch.from_numpy(adj.copy())
        new = dense.scatter_slab_cells(old, rows, uu, vv, ww)
        np.testing.assert_array_equal(old.numpy(), adj)  # untouched
        want = np.asarray(jax_dense.scatter_slab_cells(
            jnp.asarray(adj), rows, uu, vv, ww))
        np.testing.assert_array_equal(new.numpy(), want)
        assert new[2, 1, 4] == 0.5 and new[0, 3, 0] == 0.25
        assert not (new == 99.0).any() and not (new == 98.0).any()

    def test_slab_from_numpy(self, small_dtlp):
        ref = jax_dense.pack_subgraphs(small_dtlp.partition,
                                       small_dtlp.graph.w, lane=32)
        slab = slab_from_numpy(ref.adj, ref.nv, ref.gids, ref.z, epoch=3,
                               device="cpu")
        assert slab.epoch == 3 and slab.z == ref.z
        np.testing.assert_array_equal(slab.adj_dev.numpy(), ref.adj)
        with pytest.raises(ValueError, match=r"adj must be"):
            slab_from_numpy(ref.adj, ref.nv, ref.gids, ref.z + 1)

    def test_graph_from_numpy(self, small_net):
        g = _port_graph(small_net)
        assert (g.n, g.m, g.directed) == (small_net.n, small_net.m,
                                          small_net.directed)
        np.testing.assert_array_equal(g.csr_indptr, small_net.csr_indptr)
        np.testing.assert_array_equal(g.csr_dst, small_net.csr_dst)
        np.testing.assert_array_equal(g.w, small_net.w)


class TestBackends:
    @pytest.mark.parametrize("seed,z", [(0, 24), (1, 40), (2, 96)])
    def test_solve_grouped_equals_reference(self, seed, z):
        rng = np.random.default_rng(seed)
        args = masked_slab(rng, 2, 3, z)
        dj, pj = JnpBackend().solve_grouped(*(jnp.asarray(a) for a in args))
        targs = [torch.from_numpy(a) for a in args]
        for backend in (TorchBackend(), CudaBackend()):
            d, p = backend.solve_grouped(*targs)
            np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
            np.testing.assert_array_equal(p.numpy(), np.asarray(pj))

    def test_registry(self):
        assert available_engines() == ["cuda_bf", "dense_bf", "pyen"]
        assert get_engine("cuda_bf").layout is layout.HOPPER_LAYOUT
        assert get_engine("dense_bf").layout is layout.PLAIN_LAYOUT
        assert get_engine("pyen").layout is layout.PLAIN_LAYOUT
        assert get_engine("cuda_bf").packs_slab
        assert get_engine("cuda_bf").supports_mesh
        assert get_engine("dense_bf").supports_mesh
        assert not get_engine("pyen").supports_mesh
        with pytest.raises(NotImplementedError):
            SolverBackend().solve_grouped(*[None] * 6)
        with pytest.raises(ValueError, match="unknown engine"):
            get_engine("pallas_bf")


class TestGroupedYen:
    @pytest.mark.parametrize("engine", ["cuda_bf", "dense_bf"])
    def test_grouped_ksp_equals_reference(self, engine):
        """Whole lockstep-Yen rounds agree path-for-path with the
        reference's ``grouped_ksp`` (CPU device)."""
        jg = jax_grid(6, 6, seed=1)
        jd = JaxDTLP.build(jg, z=12, xi=4)
        d = DTLP.build(_port_graph(jg), z=12, xi=4)
        spec = get_engine(engine)
        jslab = jax_dense.pack_subgraphs(jd.partition, jg.w,
                                         layout=jax_layout.JNP_LAYOUT)
        slab = dense.pack_subgraphs(d.partition, d.graph.w, layout=spec.layout)
        tasks = []
        for row in range(min(3, slab.n_sub)):
            sg = d.partition.subgraphs[int(slab.gids[row])]
            tasks += [(row, 0, sg.nv - 1), (row, 1, sg.nv - 2)]
        want = jax_grouped_ksp(jslab.adj, tasks, 3, backend=JnpBackend())
        got = grouped_ksp(slab.adj, tasks, 3, backend=spec.backend,
                          device="cpu")
        assert got == want
        dense.place_slab(slab, "cpu")
        gathered = grouped_ksp(
            slab.adj, tasks, 3, backend=spec.backend, device="cpu",
            gather=lambda rows: dense.gather_slab_rows(slab, rows))
        assert gathered == want
        assert grouped_ksp(slab.adj, [], 3, backend=spec.backend,
                           device="cpu") == []


class TestClusterSlabs:
    def test_steady_state_rounds_never_stage_from_host(self):
        from repro_torch.engine.layout import TRANSFER_STATS, \
            reset_transfer_stats
        from repro_torch.service import KSPService, ServiceConfig

        g = grid_road_network(6, 6, seed=0)
        svc = KSPService(DTLP.build(g, z=12, xi=4), ServiceConfig(
            engine="cuda_bf", n_workers=2, max_in_flight=4, device="cpu"))
        for w in svc.cluster.workers:
            if w.slab is not None:
                assert w.slab.adj_dev.device.type == "cpu"
        reset_transfer_stats()
        rng = np.random.default_rng(11)
        for _ in range(3):
            s, t = map(int, rng.choice(g.n, 2, replace=False))
            svc.query(s, t, 3)
        assert TRANSFER_STATS["device_rounds"] > 0
        assert TRANSFER_STATS["host_rounds"] == 0

    def test_device_copy_tracks_patches(self):
        """Barrier and streaming patches keep the device copy bitwise in
        sync with the host slab; the previous epoch's copy is kept."""
        g = grid_road_network(6, 6, seed=2)
        cl = Cluster(DTLP.build(g, z=12, xi=4), n_workers=2,
                     engine="cuda_bf", device="cpu")
        stream = WeightUpdateStream(g, alpha=0.5, tau=0.5, seed=3)
        cl.apply_updates(*stream.next_batch())
        before = {w.wid: w.slab.adj_dev for w in cl.workers if w.slab}
        cl.apply_updates_streaming(*stream.next_batch())
        for w in cl.workers:
            if w.slab is None:
                continue
            np.testing.assert_array_equal(w.slab.adj_dev.numpy(), w.slab.adj)
            assert w.prev_slab.adj_dev is before[w.wid]
            np.testing.assert_array_equal(w.prev_slab.adj_dev.numpy(),
                                          w.prev_slab.adj)

    def test_mesh_and_missing_card_raise(self):
        """A meshless engine refuses a mesh with the reference's message
        (``tests/test_service.py``); a mesh on another device type than
        the cluster's is refused; a mesh-capable engine takes it and
        splits its slab copies; the card is never faked."""
        d = DTLP.build(grid_road_network(6, 6, seed=0), z=12, xi=4)
        with pytest.raises(ValueError, match="has no device-mesh path"):
            Cluster(d, 2, engine="pyen", device="cpu", mesh=object())
        mesh = make_host_mesh(2, device="cpu")
        cl = Cluster(d, 2, engine="cuda_bf", device="cpu", mesh=mesh)
        for w in cl.workers:
            if w.slab is not None:
                assert isinstance(w.slab.adj_dev, dense.ShardedMirror)
                assert w.solver is not None and w.s_multiple == 2
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                Cluster(d, 2, engine="cuda_bf")
            with pytest.raises(ValueError, match="device type"):
                Cluster(d, 2, engine="cuda_bf", device="cpu",
                        mesh=DeviceMesh([torch.device("cuda")]))
