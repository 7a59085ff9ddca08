"""The paper's own model: GCN at ogbn-arxiv's widths (Table I gives arxiv
128 features), and a reduced variant for small runs.  Port of
``src/repro/configs/gcn_paper.py`` without the LM matrix's ``ArchSpec``."""
from repro_torch.models.gnn import GNNConfig

full = GNNConfig(name="gcn-paper", kind="gcn", d_in=128, d_hidden=128,
                 n_classes=40, n_layers=2)
reduced = GNNConfig(name="gcn-paper-reduced", kind="gcn", d_in=16,
                    d_hidden=32, n_classes=7, n_layers=2)
