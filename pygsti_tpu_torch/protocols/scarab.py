"""Mirror-circuit benchmark analysis ("scarab"; counterpart of
pygsti_tpu/protocols/scarab.py): the MCFE design of a list of u3-cx-cz
circuits, and per-circuit process fidelities from its data, as a
VBDataFrame over a ColumnTable (no pandas needed).  Host numpy; the data
are simulated on the card (data/datasetconstruction.simulate_data).  Without
`rand_state` the bootstrap draws from an unseeded RandomState, as in the
JAX package.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.protocols.protocol import FreeformDesign, ProtocolData
from pygsti_tpu_torch.protocols.mirror_edesign import make_mirror_edesign
from pygsti_tpu_torch.tools import mcfetools as _mcfe
from pygsti_tpu_torch.tools.dataframetools import ColumnTable


def mirror_benchmark(circuits, num_mcs_per_circ=10,
                     mirroring_strategy='pauli_rc', rand_state=None):
    """Build the full mirror-circuit benchmark edesign for a list (or
    FreeformDesign) of u3-cx-cz circuits."""
    return make_mirror_edesign(circuits, num_mcs_per_circ,
                               mirroring_strategy, rand_state=rand_state)


def _family_pols(design, dataset):
    """{base_circuit_str: [effective polarizations]} for one family."""
    out = collections.defaultdict(list)
    for circ, auxlist in design.aux_info.items():
        for aux in auxlist:
            bs = aux['idealout']
            row = dataset[circ]
            hd = _mcfe.hamming_distance_counts(row, circ, bs)
            out[aux.get('base_circuit', '?')].append(
                _mcfe.effective_polarization(hd))
    return out


def calculate_mirror_benchmark_results(unmirrored_design, mirrored_data,
                                       include_dropped_gates=False,
                                       bootstrap=True, num_bootstraps=50,
                                       rand_state=None, verbose=False):
    """Per-circuit process-fidelity estimates from MCFE data, as a
    VBDataFrame (reference: scarab.py:293)."""
    from pygsti_tpu_torch.protocols.vbdataframe import VBDataFrame
    rng = rand_state if rand_state is not None else np.random.RandomState()
    ed = mirrored_data.edesign
    ds = mirrored_data.dataset
    strategy = 'pauli_rc' if 'br' in ed.keys() else 'central_pauli'

    if strategy == 'pauli_rc':
        br = _family_pols(ed['br'], ds)
        rr = _family_pols(ed['rr'], ds)
        ref = _family_pols(ed['ref'], ds)
    else:
        br = _family_pols(ed['cp'], ds)
        rr = None
        ref = _family_pols(ed['cpref'], ds)

    if isinstance(unmirrored_design, FreeformDesign):
        base_circuits = list(unmirrored_design.aux_info.keys())
    else:
        base_circuits = list(unmirrored_design)

    rows = []
    for c in base_circuits:
        key = c.str
        n = len(c.line_labels)
        brs = np.asarray(br.get(key, []))
        refs = np.asarray(ref.get(key, []))
        if strategy == 'pauli_rc':
            rrs = np.asarray(rr.get(key, []))
            pfid = _mcfe.rc_predicted_process_fidelity(brs, rrs, refs, n)
        else:
            pfid = _mcfe.predicted_process_fidelity_for_central_pauli_mcs(
                brs, refs, n)
        row = {'Circuit': key, 'Width': n, 'Depth': c.depth,
               'process_fidelity': pfid,
               'polarization': _mcfe.fidelity_to_polarization(pfid, n)
               if np.isfinite(pfid) else np.nan,
               'total_counts': int(np.sum([ds[cc].total
                                           for cc, al in ed[
                                               'br' if strategy == 'pauli_rc'
                                               else 'cp'].aux_info.items()
                                           for a in al
                                           if a.get('base_circuit') == key]))}
        if bootstrap and strategy == 'pauli_rc' and len(brs) and len(refs):
            bs_vals = _mcfe.rc_bootstrap_predicted_pfid(
                brs, rrs, refs, n, num_bootstraps, rng)
            row['process_fidelity_std'] = float(np.nanstd(bs_vals))
        rows.append(row)
    return VBDataFrame(ColumnTable.from_rows(rows), x_axis='Depth', y_axis='Width')
