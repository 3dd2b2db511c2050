from repro_torch.runtime.transport import FaultSpec, Message, Network  # noqa: F401
from repro_torch.runtime.reliable import ReliableMessenger, RequestTimeout  # noqa: F401
from repro_torch.runtime.jobs import JobSpec, JobStatus  # noqa: F401
from repro_torch.runtime.scp import FlareRuntime  # noqa: F401
from repro_torch.runtime.streaming import MetricCollector, SummaryWriter  # noqa: F401
from repro_torch.runtime.provision import Provisioner, StartupKit  # noqa: F401
