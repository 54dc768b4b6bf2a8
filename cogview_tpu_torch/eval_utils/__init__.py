from .fid import compute_statistics, fid_from_features, frechet_distance
from .inception_score import inception_score

__all__ = [
    "frechet_distance",
    "compute_statistics",
    "fid_from_features",
    "inception_score",
]
