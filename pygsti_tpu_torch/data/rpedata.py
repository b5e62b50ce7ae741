"""RPE dataset construction import-path parity (counterpart of
pygsti_tpu/data/rpedata.py); implementation in extras/rpe/rpeconstruction."""

from pygsti_tpu_torch.extras.rpe.rpeconstruction import create_rpe_dataset


def make_rpe_data_set(model_or_dataset, string_list_d, num_samples,
                      sample_error='binomial', seed=None, device="cuda"):
    """Reference-spelled alias of create_rpe_dataset (reference:
    data/rpedata.make_rpe_data_set:16); a model is simulated on `device`."""
    return create_rpe_dataset(model_or_dataset, string_list_d, num_samples,
                              sample_error=sample_error, seed=seed, device=device)
