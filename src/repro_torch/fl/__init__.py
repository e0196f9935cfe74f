"""Federation pieces: numpy-only copies of ``repro/fl/partition.py`` and
``sampling.py``, the cost tables (copy of ``repro/fl/comm.py``) and the
server optimizers (port of ``repro/fl/server.py``)."""
from repro_torch.fl.comm import comm_cost, compute_cost
from repro_torch.fl.partition import dirichlet_partition, heterogeneity_coefficients
from repro_torch.fl.sampling import sample_clients
from repro_torch.fl.server import ServerState, server_init, server_update
