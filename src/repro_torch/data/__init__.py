"""Data helpers of the port (numpy copies of the reference's partitioners,
and its synthetic pipelines with torch generators for the draws)."""
from repro_torch.data.partition import dirichlet_partition, uniform_partition
from repro_torch.data.synthetic import (
    TokenStream,
    federated_token_batches,
    logistic_client_data,
    make_batch,
)

__all__ = [
    "TokenStream", "federated_token_batches", "logistic_client_data",
    "make_batch", "dirichlet_partition", "uniform_partition",
]
