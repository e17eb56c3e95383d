from audio2photoreal_tpu_torch.models.audio_encoder import Wav2VecFeatureExtractor
from audio2photoreal_tpu_torch.models.film_transformer import CondTokens, FiLMDenoiser

__all__ = ["CondTokens", "FiLMDenoiser", "Wav2VecFeatureExtractor"]
