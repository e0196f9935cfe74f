"""Federation pieces: numpy-only copies of ``repro/fl/partition.py`` and
``sampling.py``, and the server optimizers (port of ``repro/fl/server.py``)."""
from repro_torch.fl.partition import dirichlet_partition, heterogeneity_coefficients
from repro_torch.fl.sampling import sample_clients
from repro_torch.fl.server import ServerState, server_init, server_update
