from repro_torch.data.synthetic import SyntheticLMDataset, make_batch_iterator  # noqa: F401
