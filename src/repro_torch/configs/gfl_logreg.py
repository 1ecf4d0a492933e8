"""gfl-logreg: the paper's own Section-V experiment configuration.

P=10 servers x K=50 clients, N=100 samples each, M=2 logistic regression,
mu=0.1, rho=0.01, sigma_g=0.2, full topology (Fig. 2)."""
from repro_torch.configs.base import GFLConfig

NAME = "gfl-logreg"
SOURCE = "Rizk & Sayed 2021, Section V"

GFL = GFLConfig(num_servers=10, clients_per_server=50, privacy="hybrid",
                sigma_g=0.2, mu=0.1, topology="full", grad_bound=10.0)
RHO = 0.01
SAMPLES_PER_CLIENT = 100
DIM = 2
