from .monitor import Heartbeat, PreemptionHandler, StragglerEvent, StragglerMonitor
