from audio2photoreal_tpu_torch.data.dataset import SocialDataset, load_local_data
from audio2photoreal_tpu_torch.data.stats import DataStats
from audio2photoreal_tpu_torch.data.fixtures import make_synthetic_person

__all__ = ["SocialDataset", "load_local_data", "DataStats", "make_synthetic_person"]
