from repro_torch.data.synthetic import SyntheticLMDataset, make_batch_iterator  # noqa: F401
from repro_torch.data.partition import dirichlet_partition, iid_partition  # noqa: F401
from repro_torch.data.loader import FederatedDataLoader  # noqa: F401
