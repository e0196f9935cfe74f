"""numpy-only copies of ``repro/data`` (the port imports nothing of ``repro``)."""
from repro_torch.data.synthetic import TASKS, make_task
