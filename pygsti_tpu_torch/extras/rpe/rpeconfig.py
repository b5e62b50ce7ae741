"""RPEconfig: the gate-set conventions an RPE analysis fits (counterpart of
pygsti_tpu/extras/rpe/rpeconfig.py)."""


class RPEconfig(object):
    """The entries of a convention dictionary as attributes."""

    def __init__(self, input_dict):
        for k, v in input_dict.items():
            setattr(self, k, v)
        self._dict = dict(input_dict)

    def to_dict(self):
        return dict(self._dict)
