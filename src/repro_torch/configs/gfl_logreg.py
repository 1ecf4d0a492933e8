"""gfl-logreg: the paper's own Section-V experiment configuration.

P=10 servers x K=50 clients, N=100 samples each, M=2 logistic regression,
mu=0.1, rho=0.01, sigma_g=0.2, full topology (Fig. 2)."""
from repro_torch.configs.base import GFLConfig, ModelConfig

NAME = "gfl-logreg"
SOURCE = "Rizk & Sayed 2021, Section V"

# the registry's entry, equal to the reference's (no model runs from it)
CONFIG = ModelConfig(
    name=NAME,
    family="dense",
    num_layers=0,
    d_model=2,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=2,
    source=SOURCE,
)

GFL = GFLConfig(num_servers=10, clients_per_server=50, privacy="hybrid",
                sigma_g=0.2, mu=0.1, topology="full", grad_bound=10.0)
RHO = 0.01
SAMPLES_PER_CLIENT = 100
DIM = 2
