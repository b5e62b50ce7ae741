"""Crosstalk results container (counterpart of
pygsti_tpu/extras/crosstalk/objects.py).

Holds the PC-algorithm pipeline outputs: data matrix, skeleton, CPDAG,
region-pair crosstalk matrix, and TVD edge weights, plus text and plot
summaries.  Only the plot needs networkx and matplotlib, and imports them
when it is called.
"""

from __future__ import annotations

import numpy as np


class CrosstalkResults(object):
    """Results of PC-algorithm crosstalk detection
    (reference objects.py:14-57: same attribute surface)."""

    def __init__(self):
        self.name = None
        self.data = None
        self.pygsti_ds = None
        self.number_of_regions = None
        self.settings = None
        self.number_of_datapoints = None
        self.number_of_columns = None
        self.confidence = None
        self.skel = None            # pcalg.Skeleton
        self.sep_set = None
        self.graph = None           # pcalg.PDAG: the CPDAG
        self.cmatrix = None         # [R,R] 1 where crosstalk detected
        self.is_edge_ct = None      # per-CPDAG-edge crosstalk flag
        self.crosstalk_detection_confidence = None
        self.node_labels = None
        self.setting_indices = None
        self.edge_weights = None
        self.edge_tvds = None       # {edge idx: [levels,levels] TVD matrix}
        self.max_tvds = None
        self.median_tvds = None
        self.max_tvd_explanations = None

    def any_crosstalk_detect(self):
        """True if any region pair shows crosstalk
        (reference objects.py:49)."""
        return bool(self.cmatrix is not None and np.any(self.cmatrix))

    @property
    def crosstalk_detected(self):
        return self.any_crosstalk_detect()

    @property
    def crosstalk_pairs(self):
        """Sorted list of detected (region_i, region_j) pairs."""
        if self.cmatrix is None:
            return []
        return sorted({(int(i), int(j))
                       for i, j in zip(*np.nonzero(self.cmatrix))})

    def show_crosstalk_table(self, precision=5):
        """Text table of crosstalk edges with TVD weights
        (reference objects.py:304 renders the same content graphically)."""
        lines = ["Crosstalk edges (confidence %s):" % self.confidence]
        if self.graph is None:
            return "\n".join(lines + ["  (no graph computed)"])
        edges = list(self.graph.edges())
        any_ct = False
        for idx, edge in enumerate(edges):
            if self.is_edge_ct is not None and self.is_edge_ct[idx]:
                any_ct = True
                mt = (self.max_tvds or {}).get(idx)
                med = (self.median_tvds or {}).get(idx)
                lines.append("  %s -> %s   max TVD: %s   median TVD: %s" % (
                    self.node_labels.get(edge[0], edge[0]),
                    self.node_labels.get(edge[1], edge[1]),
                    ("%.*f" % (precision, mt)) if mt is not None else "n/a",
                    ("%.*f" % (precision, med)) if med is not None else "n/a"))
        if not any_ct:
            lines.append("  none detected")
        return "\n".join(lines)

    def plot_crosstalk_graph(self, savepath=None):
        """Draw the CPDAG with crosstalk edges highlighted (reference
        objects.py:222).  Needs networkx and matplotlib: without them it
        raises ImportError."""
        try:
            import matplotlib.pyplot as plt
            import networkx as nx
        except ImportError as e:
            raise ImportError("plot_crosstalk_graph needs networkx and matplotlib: %s" % e) from e
        g = nx.DiGraph()
        g.add_nodes_from(self.graph.nodes())
        edges = self.graph.edges()
        g.add_edges_from(edges)
        fig, ax = plt.subplots(figsize=(6, 6))
        pos = nx.circular_layout(g)
        colors = ['red' if (self.is_edge_ct is not None and self.is_edge_ct[i])
                  else 'gray' for i in range(len(edges))]
        nx.draw_networkx(g, pos, ax=ax, labels=self.node_labels, edgelist=edges,
                         edge_color=colors, node_color='lightblue')
        if savepath:
            fig.savefig(savepath)
            plt.close(fig)
        return fig

    def __str__(self):
        if not self.any_crosstalk_detect():
            return ("No crosstalk detected (confidence %s)" % self.confidence)
        return ("Crosstalk detected between region pairs: %s"
                % (self.crosstalk_pairs,))
