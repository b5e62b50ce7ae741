"""Legacy model packs with positional gate names ('Gx', 'Gix', ...) and
circuits without qubit labels (counterpart of
pygsti_tpu/modelpacks/legacy/).  Import the modules one by one, e.g.
``from pygsti_tpu_torch.modelpacks.legacy import std1Q_XYI``."""
