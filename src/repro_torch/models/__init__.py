from repro_torch.models.api import SplitModel, get_subtree  # noqa: F401
