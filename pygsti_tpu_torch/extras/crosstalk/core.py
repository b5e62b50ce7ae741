"""Crosstalk detection (counterpart of pygsti_tpu/extras/crosstalk/core.py).

Two detectors are provided:

- :func:`do_basic_crosstalk_detection` -- the reference's PC-algorithm
  causal-discovery pipeline (core.py:186-675): build an integer data matrix
  whose columns are per-region OUTCOMES followed by per-region SETTINGS,
  estimate the causal-graph skeleton with a discrete G^2 CI test, orient it
  into a CPDAG, classify edges that connect one region's outcome to another
  region's outcome/setting as crosstalk, and weight each crosstalk edge by
  total-variation distances between conditional outcome distributions.
  The PC/G^2 machinery is implemented natively in :mod:`.pcalg` (the
  reference shells out to the external ``pcalg``/``gsq`` packages).

- :func:`do_pairwise_crosstalk_detection` -- a lighter stratified
  chi-squared contingency test per region pair (the conditional-independence
  formulation of Sarovar et al., Quantum 4, 321) with Fisher combination and
  Bonferroni correction; directional and cheap, useful as a first pass.
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.stats as stats

from . import pcalg as _pcalg
from .objects import CrosstalkResults


class PairwiseCrosstalkResults(object):
    def __init__(self, pvalues, significance, crosstalk_detected, pairs,
                 num_regions=None, effect_sizes=None):
        self.pvalues = pvalues          # {(outcome_region, setting_region): p}
        self.significance = significance
        self.crosstalk_detected = crosstalk_detected
        self.crosstalk_pairs = pairs
        self.num_regions = num_regions
        self.effect_sizes = effect_sizes or {}  # Cramer's V per pair

    def crosstalk_matrix(self):
        """[R, R] matrix of -log10 p-values (the reference's crosstalk
        graph weights; 0 on the diagonal / untested pairs)."""
        R = self.num_regions or (max(max(k) for k in self.pvalues) + 1
                                 if self.pvalues else 0)
        M = np.zeros((R, R))
        for (i, j), p in self.pvalues.items():
            M[i, j] = -np.log10(max(p, 1e-300))
        return M

    def __str__(self):
        if not self.crosstalk_detected:
            return "No crosstalk detected (significance %g)" % self.significance
        return "Crosstalk detected between region pairs: %s" % (self.crosstalk_pairs,)


def do_pairwise_crosstalk_detection(data_tuples, num_regions, significance=0.05,
                                    verbosity=1):
    """Run pairwise crosstalk detection on experiment tuples.

    data_tuples: list of (settings, outcomes) where `settings` and `outcomes`
    are length-num_regions tuples -- the experimental setting (e.g. which
    circuit was applied) and the measured outcome for each region.
    """
    # build contingency tables: outcomes of region i vs settings of region j
    pvalues = {}
    effect_sizes = {}
    tested = 0
    for i in range(num_regions):
        for j in range(num_regions):
            if i == j:
                continue
            table = collections.defaultdict(lambda: collections.Counter())
            for settings, outcomes in data_tuples:
                # condition on region i's own setting to isolate j's influence
                table[settings[i]][(settings[j], outcomes[i])] += 1
            # for each own-setting stratum, test outcome-vs-foreign-setting
            stratum_pvals = []
            stratum_effects = []
            for own_setting, counter in table.items():
                foreign_settings = sorted({k[0] for k in counter})
                outcomes_seen = sorted({k[1] for k in counter})
                if len(foreign_settings) < 2 or len(outcomes_seen) < 2:
                    continue
                mat = np.array([[counter.get((fs, oc), 0) for oc in outcomes_seen]
                                for fs in foreign_settings], dtype=float)
                if mat.sum() == 0:
                    continue
                # drop empty rows/cols
                mat = mat[mat.sum(axis=1) > 0][:, mat.sum(axis=0) > 0]
                if mat.shape[0] < 2 or mat.shape[1] < 2:
                    continue
                chi2_stat, p, _, _ = stats.chi2_contingency(mat)
                n_tot = mat.sum()
                kdim = min(mat.shape) - 1
                cramers_v = np.sqrt(chi2_stat / (n_tot * max(kdim, 1)))
                stratum_pvals.append(p)
                stratum_effects.append(cramers_v)
            if stratum_pvals:
                # Fisher combination over strata
                stat = -2 * np.sum(np.log(np.clip(stratum_pvals, 1e-300, 1)))
                p_comb = stats.chi2.sf(stat, 2 * len(stratum_pvals))
                pvalues[(i, j)] = p_comb
                effect_sizes[(i, j)] = float(np.median(stratum_effects))
                tested += 1
    threshold = significance / max(tested, 1)  # Bonferroni
    pairs = [k for k, p in pvalues.items() if p < threshold]
    return PairwiseCrosstalkResults(pvalues, significance, len(pairs) > 0, pairs,
                                    num_regions=num_regions,
                                    effect_sizes=effect_sizes)


def tuples_to_data_matrix(data_tuples, num_regions):
    """Convert (settings, outcomes) tuples -- one setting and one outcome per
    region -- into the [n, 2R] integer matrix form consumed by
    :func:`do_basic_crosstalk_detection` (outcome columns first)."""
    rows = [list(outs) + list(sets) for (sets, outs) in data_tuples]
    return np.asarray(rows, dtype=int), [1] * num_regions


def form_ct_data_matrix(ds, number_of_regions, settings, filter_lengths=None):
    """Convert a DataSet with per-circuit ``auxInfo[circuit]['settings']``
    metadata into the integer data matrix analyzed by the PC pipeline
    (reference: crosstalk/core.py:66 and the DataSet branch of
    do_basic_crosstalk_detection, core.py:228-295).

    Each circuit's aux 'settings' maps region tuples (e.g. ``(0,)``) to the
    integer setting applied there; each shot contributes one row of
    [outcome bits per region..., settings...].
    """
    filter_lengths = filter_lengths or []
    num_settings = sum(settings)
    data = []
    for circ in ds.keys():
        if filter_lengths and len(circ) not in filter_lengths:
            continue
        settings_row = ds.auxInfo[circ].get('settings', {})
        templine_set = [0] * num_settings
        setting_indices = {x: sum(settings[:x]) for x in range(number_of_regions)}
        for key, val in settings_row.items():
            if len(key) == 1:
                templine_set[setting_indices[key[0]]] = val
            else:
                raise NotImplementedError(
                    "Multi-region settings not supported (reference prints "
                    "'Two qubit gate, not sure what to do!!' and gives up)")
        row = ds[circ]
        for outcome, cnt in row.counts.items():
            bits = outcome[0] if isinstance(outcome, tuple) else outcome
            line = [int(bits[r]) for r in range(number_of_regions)]
            line += templine_set
            for _ in range(int(round(cnt))):
                data.append(line)
    return np.asarray(data, dtype=int)


def do_basic_crosstalk_detection(ds, number_of_regions, settings=None,
                                 confidence=0.95, verbosity=1, name=None,
                                 assume_independent_settings=True,
                                 filter_lengths=None):
    """PC-algorithm crosstalk detection on multiqubit data
    (reference: crosstalk/core.py:186 with identical pipeline semantics).

    ds : one of
        - int ndarray [n, number_of_regions + sum(settings)] -- outcome
          columns for each region followed by setting columns,
        - a DataSet whose ``auxInfo[circuit]['settings']`` records per-region
          settings (converted via :func:`form_ct_data_matrix`),
        - a list of (settings, outcomes) tuples (one setting per region).
    settings : list, number of setting variables per region (default: one
        setting column per region).

    Returns a :class:`CrosstalkResults` with the skeleton, CPDAG, region
    crosstalk matrix and TVD edge weights.
    """
    from pygsti_tpu_torch.data.dataset import DataSet as _DataSet

    if isinstance(ds, _DataSet):
        if settings is None:
            settings = [1] * number_of_regions
        data = form_ct_data_matrix(ds, number_of_regions, settings,
                                   filter_lengths)
        pygsti_ds = ds
    elif isinstance(ds, (list, tuple)):
        data, auto_settings = tuples_to_data_matrix(ds, number_of_regions)
        settings = settings if settings is not None else auto_settings
        pygsti_ds = None
    else:
        data = np.asarray(ds, dtype=int)
        if settings is None:
            settings = [1] * number_of_regions
        pygsti_ds = None
    if len(settings) != number_of_regions:
        raise ValueError("settings should be a list of the same length as number_of_regions")
    if data.shape[1] != number_of_regions + sum(settings):
        raise ValueError("Mismatch between settings and the number of data columns")

    num_data, num_columns = data.shape

    results = CrosstalkResults()
    results.name = name
    results.data = data
    results.pygsti_ds = pygsti_ds
    results.number_of_regions = number_of_regions
    results.settings = settings
    results.number_of_datapoints = num_data
    results.number_of_columns = num_columns
    results.confidence = confidence

    # ---- causal graph skeleton (settings mutually independent by design) --
    if assume_independent_settings:
        ignore_edges = [(s1, s2)
                        for s1 in range(number_of_regions, num_columns)
                        for s2 in range(number_of_regions, s1)]
    else:
        ignore_edges = []

    skel, sep_set = _pcalg.estimate_skeleton(
        _pcalg.g_square_dis, data, 1 - confidence, ignore_edges)
    g = _pcalg.estimate_cpdag(skel_graph=skel, sep_set=sep_set)
    results.skel = skel
    results.sep_set = sep_set
    results.graph = g

    # column index of the first setting for each region
    setting_indices = {x: number_of_regions + sum(settings[:x])
                       for x in range(number_of_regions)}
    results.setting_indices = setting_indices

    def _region_of_setting(col):
        for region in range(number_of_regions):
            hi = (setting_indices[region + 1]
                  if region < number_of_regions - 1 else num_columns)
            if setting_indices[region] <= col < hi:
                return region
        raise ValueError(col)

    node_labels = {}
    for col in range(num_columns):
        if col < number_of_regions:
            node_labels[col] = r'R$_{%d}$' % col
        else:
            region = _region_of_setting(col)
            node_labels[col] = r'S$_{%d}^{(%d)}$' % (
                region, col - setting_indices[region])
    results.node_labels = node_labels

    # ---- classify edges + TVD weights (reference core.py:430-668) ---------
    edges = list(g.edges())
    cmatrix = np.zeros((number_of_regions, number_of_regions))
    is_edge_ct = np.zeros(len(edges))
    edge_tvds, max_tvds, median_tvds = {}, {}, {}

    def _tvd_from_counts(vals1, vals2):
        n1, n2 = len(vals1), len(vals2)
        if n1 == 0 or n2 == 0:
            return 0.0
        l1, c1 = np.unique(vals1, return_counts=True)
        l2, c2 = np.unique(vals2, return_counts=True)
        d2 = dict(zip(l2.tolist(), (c2 / n2).tolist()))
        tvd_sum = sum(abs(c / n1 - d2.pop(lev, 0.0))
                      for lev, c in zip(l1.tolist(), c1.tolist()))
        tvd_sum += sum(d2.values())
        return tvd_sum / 2.0

    for idx, (source, dest) in enumerate(edges):
        src_is_out = source < number_of_regions
        dst_is_out = dest < number_of_regions
        if src_is_out and dst_is_out:
            cmatrix[source, dest] = 1
            is_edge_ct[idx] = 1
        elif src_is_out and not dst_is_out:
            region = _region_of_setting(dest)
            if region != source:
                cmatrix[source, region] = 1
                is_edge_ct[idx] = 1
        elif not src_is_out and dst_is_out:
            region = _region_of_setting(source)
            if region != dest:
                cmatrix[region, dest] = 1
                is_edge_ct[idx] = 1

        if not is_edge_ct[idx]:
            continue

        source_levels = np.unique(data[:, source])
        nlev = len(source_levels)
        tvds = np.zeros((nlev, nlev))
        calc = []
        if src_is_out:
            # condition directly on the source variable
            for i in range(nlev):
                for j in range(i):
                    m1 = data[data[:, source] == source_levels[i], dest]
                    m2 = data[data[:, source] == source_levels[j], dest]
                    tvds[i, j] = tvds[j, i] = _tvd_from_counts(m1, m2)
                    calc.append(tvds[i, j])
        else:
            # source is a setting, dest an outcome: compare outcome
            # distributions at matched settings of the destination region,
            # taking the worst case over common destination settings
            dest_setting = setting_indices[dest]
            for i in range(nlev):
                for j in range(i):
                    m1 = data[data[:, source] == source_levels[i]]
                    m2 = data[data[:, source] == source_levels[j]]
                    common = (set(np.unique(m1[:, dest_setting]).tolist())
                              & set(np.unique(m2[:, dest_setting]).tolist()))
                    if not common:
                        tvds[i, j] = tvds[j, i] = -1
                        continue
                    max_tvd = 0.0
                    for lev in common:
                        t = _tvd_from_counts(
                            m1[m1[:, dest_setting] == lev, dest],
                            m2[m2[:, dest_setting] == lev, dest])
                        max_tvd = max(max_tvd, t)
                    tvds[i, j] = tvds[j, i] = max_tvd
                    calc.append(tvds[i, j])
        edge_tvds[idx] = tvds
        if calc:
            max_tvds[idx] = float(np.max(calc))
            median_tvds[idx] = float(np.median(calc))

    results.cmatrix = cmatrix
    results.is_edge_ct = is_edge_ct
    results.edge_weights = np.array([max_tvds.get(i, 0.0)
                                     for i in range(len(edges))])
    results.edge_tvds = edge_tvds
    results.max_tvds = max_tvds
    results.median_tvds = median_tvds
    if verbosity > 0 and results.any_crosstalk_detect():
        print("Crosstalk detected. Region pairs: %s" % results.crosstalk_pairs)
    return results


def form_ct_data_tuples(ds, region_qubits):
    """Convert a DataSet into crosstalk (settings, outcomes) tuples
    (reference: crosstalk/core.py:66 form_ct_data_matrix).

    region_qubits: list of qubit-label tuples, one per region.  Each
    circuit's per-region SETTING is the subcircuit acting on that region's
    qubits (the layer labels restricted to them); each shot contributes one
    tuple with the per-region OUTCOME bits.
    """
    qubit_pos = {}
    all_qubits = []
    for r, qs in enumerate(region_qubits):
        for q in qs:
            all_qubits.append(q)

    data_tuples = []
    for c in ds.keys():
        lls = list(c.line_labels) if c.line_labels else all_qubits
        pos = {q: i for i, q in enumerate(lls)}
        settings = []
        for qs in region_qubits:
            qset = set(qs)
            sub = []
            for layer in c.layertup:
                comps = layer.components if not layer.is_simple else (layer,)
                for comp in comps:
                    ssl = comp.sslbls
                    if ssl is None or qset.intersection(ssl):
                        sub.append(str(comp))
            settings.append(tuple(sub))
        row = ds[c]
        for outcome, cnt in row.counts.items():
            bits = outcome[0]
            outs = tuple(
                ''.join(bits[pos[q]] for q in qs if q in pos)
                for qs in region_qubits)
            for _ in range(int(round(cnt))):
                data_tuples.append((tuple(settings), outs))
    return data_tuples


def do_crosstalk_detection_on_dataset(ds, region_qubits, significance=0.05,
                                      verbosity=1):
    """End-to-end: DataSet -> tuples -> pairwise detection (reference:
    core.py:186 operating directly on a pyGSTi dataset)."""
    tuples = form_ct_data_tuples(ds, region_qubits)
    return do_pairwise_crosstalk_detection(tuples, len(region_qubits),
                                           significance, verbosity)


def crosstalk_detection_experiment(pspec_or_qubits, lengths, circuits_per_length,
                                   idle_prob=0.1, one_q_gate_names=('Gxpi2', 'Gypi2'),
                                   seed=None, circuit_population_sz=3):
    """Random-circuit crosstalk-detection experiment, '1Q' region structure
    (reference: crosstalk/core.py:675 crosstalk_detection_experiment):
    each qubit is a region; for each length, each region has a population
    of `circuit_population_sz` random single-qubit sequences, and each
    circuit runs one of them per region (or idles it with probability
    idle_prob).  Returns (circuits, settings_list) where settings_list[k][r]
    names the sequence applied to region r in circuit k: 0 for the idle,
    else 1 + its index in the population + circuit_population_sz times the
    length's index in `lengths`, so that no two sequences share a setting.

    The population is small on purpose (at 4 qubits, lengths 10-40, 200
    circuits per length and 100 shots, a planted two-qubit Hamiltonian
    error was found on 16 of 16 seeded designs with 3 sequences, 3 of 4
    with 4, and 6 of 8 with 2): every setting column of the data
    matrix has a level per sequence, and the G^2 test calls two columns
    independent when there are fewer than 10 samples per degree of
    freedom, which conditioning on a setting multiplies by its levels.
    The JAX package draws max(4, circuits_per_length) sequences, so at 200
    circuits per length every test conditioned on a setting finds
    independence and the PC search deletes every crosstalk edge; and its
    settings start again at 1 for each length, so that over several
    lengths one setting names several sequences, the outcomes depend on
    the length, which no column of the data matrix holds, and every
    outcome looks dependent on every setting (ROADMAP.md section 3).
    ``circuit_population_sz=max(4, circuits_per_length)`` draws its
    circuits.
    """
    from pygsti_tpu_torch.baseobjs.label import Label, LabelTupTup
    from pygsti_tpu_torch.circuits.circuit import Circuit
    rng = np.random.RandomState(seed)
    qubits = list(getattr(pspec_or_qubits, 'qubit_labels', pspec_or_qubits))
    n_cand = int(circuit_population_sz)
    circuits, settings_list = [], []
    for li, L in enumerate(lengths):
        cands = [[rng.choice(len(one_q_gate_names), size=L)
                  for _ in range(n_cand)] for _q in qubits]
        for _k in range(circuits_per_length):
            layers = [[] for _ in range(L)]
            settings = []
            for r, q in enumerate(qubits):
                if rng.rand() < idle_prob:
                    settings.append(0)
                    continue
                idx = rng.randint(n_cand)
                settings.append(1 + idx + n_cand * li)
                for t, g in enumerate(cands[r][idx]):
                    layers[t].append(Label(one_q_gate_names[g], q))
            layer_labels = []
            for comps in layers:
                if len(comps) == 0:
                    layer_labels.append(Label(()))
                elif len(comps) == 1:
                    layer_labels.append(comps[0])
                else:
                    layer_labels.append(LabelTupTup.init(tuple(comps)))
            circuits.append(Circuit(layer_labels, tuple(qubits)))
            settings_list.append(tuple(settings))
    return circuits, settings_list
