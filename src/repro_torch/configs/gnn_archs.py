"""The four assigned GNN architectures (exact published configs)."""

from repro_torch.models.gnn import GNNConfig

from .gnn_family import make_gnn_arch

# dimenet [arXiv:2003.03123]: 6 blocks, d=128, 8 bilinear, 7 spherical,
# 6 radial
DIMENET = make_gnn_arch(
    "dimenet",
    GNNConfig(
        name="dimenet",
        kind="dimenet",
        n_layers=6,
        d_hidden=128,
        n_bilinear=8,
        n_spherical=7,
        n_radial=6,
        task="graph_reg",
    ),
    describe="directional message passing; triplet-gather kernel regime",
)

# meshgraphnet [arXiv:2010.03409]: 15 layers, d=128, sum aggregator,
# 2-layer MLPs
MESHGRAPHNET = make_gnn_arch(
    "meshgraphnet",
    GNNConfig(
        name="meshgraphnet",
        kind="mgn",
        n_layers=15,
        d_hidden=128,
        aggregator="sum",
        mlp_layers=2,
        edge_in_dim=4,
        task="node_reg",
    ),
    describe="encode-process-decode edge-featured MPNN",
)

# graphsage-reddit [arXiv:1706.02216]: 2 layers, d=128, mean aggregator,
# sample sizes 25-10
GRAPHSAGE = make_gnn_arch(
    "graphsage-reddit",
    GNNConfig(
        name="graphsage-reddit",
        kind="sage",
        n_layers=2,
        d_hidden=128,
        aggregator="mean",
        task="node_class",
    ),
    describe="sampled-neighborhood mean aggregation; real fanout sampler "
    "for minibatch_lg",
)

# gin-tu [arXiv:1810.00826]: 5 layers, d=64, sum aggregator, learnable eps
GIN = make_gnn_arch(
    "gin-tu",
    GNNConfig(
        name="gin-tu",
        kind="gin",
        n_layers=5,
        d_hidden=64,
        aggregator="sum",
        learnable_eps=True,
        task="node_class",
    ),
    describe="isomorphism network, sum aggregation + MLP",
)
