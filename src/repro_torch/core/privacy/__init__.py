"""Privacy layer of the GFL protocol (port of ``repro.core.privacy``): the
noise samplers, client-level secure aggregation, graph-homomorphic server
noise, the accountant and the mechanism registry — the reference's 28
public names."""
from repro_torch.core.privacy.noise import (
    get_sampler,
    laplace_from_uniform,
    sample_gaussian,
    sample_laplace,
)
from repro_torch.core.privacy.secure_agg import (
    masked_client_mean,
    masked_client_mean_dropout_vec,
    masked_client_mean_with_dropout,
    pair_stream_matrix,
    pairwise_masks,
    pairwise_masks_vec,
)
from repro_torch.core.privacy.homomorphic import (
    homomorphic_combine_noise,
    homomorphic_noise_matrix,
)
from repro_torch.core.privacy.accountant import (
    PrivacyAccountant,
    amplified_release_epsilon,
    epsilon_at,
    gaussian_epsilon_at,
    gaussian_sigma_for_epsilon,
    scheduled_epsilon_spent,
    scheduled_sigma_at,
    sensitivity,
    sigma_for_epsilon,
)
from repro_torch.core.privacy.mechanism import (
    NoiseProfile,
    PrivacyMechanism,
    RoundContext,
    get_mechanism,
    list_mechanisms,
    mechanism_for,
    register_mechanism,
)

__all__ = [
    "laplace_from_uniform",
    "sample_laplace",
    "sample_gaussian",
    "get_sampler",
    "pairwise_masks",
    "pairwise_masks_vec",
    "pair_stream_matrix",
    "masked_client_mean",
    "masked_client_mean_dropout_vec",
    "masked_client_mean_with_dropout",
    "homomorphic_noise_matrix",
    "homomorphic_combine_noise",
    "PrivacyAccountant",
    "amplified_release_epsilon",
    "epsilon_at",
    "gaussian_epsilon_at",
    "gaussian_sigma_for_epsilon",
    "scheduled_epsilon_spent",
    "scheduled_sigma_at",
    "sensitivity",
    "sigma_for_epsilon",
    "NoiseProfile",
    "PrivacyMechanism",
    "RoundContext",
    "get_mechanism",
    "list_mechanisms",
    "mechanism_for",
    "register_mechanism",
]
