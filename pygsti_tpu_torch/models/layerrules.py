"""Layer rules (counterpart of pygsti_tpu/models/layerrules.py).

Implicit models build a layer's operator from the recipe registered for it
(LocalNoiseModel.register_layer, and the cloud factors CloudNoiseModel
appends) rather than from a separate rules object; LayerRules is the base
name those configurations derive from."""


class LayerRules(object):
    """Base of the layer-rules records (see LocalNoiseModel._layer_recipes
    for the working mechanism)."""
