"""Host-side streaming runtime (paper §3.2), PyTorch port: spout →
dispatcher → monitor for one stream, the multi-tenant lane scheduler
(continuous batching across videos) behind ``ElasticServer``, with the
zero-copy overlapped tick I/O of ``iobuf``, the elastic lane autoscaler
(a ladder of warmed lane counts) and the fleet tier over several hosts."""
from repro_torch.stream.autoscale import (DEFAULT_RUNGS, LaneAutoscaler,
                                          ScalePolicy, ladder_rungs)
from repro_torch.stream.dispatcher import DispatchStats, StreamDispatcher
from repro_torch.stream.elastic import ElasticServer
from repro_torch.stream.fleet import FleetScheduler
from repro_torch.stream.iobuf import (CopyStreams, LaneTickStep,
                                      TickBufferPool, donation_supported,
                                      fetch_valid, is_overlap_step)
from repro_torch.stream.monitor import DEADLINE_CLOCK, Monitor, MonitorStats
from repro_torch.stream.scheduler import (MultiStreamScheduler, ServeReport,
                                          StreamReport, StreamRequest)
from repro_torch.stream.spout import FrameBatch, Spout, wire_frame
from repro_torch.stream.state import StreamStateStore

__all__ = ["Monitor", "MonitorStats", "DEADLINE_CLOCK", "Spout",
           "FrameBatch", "wire_frame", "StreamDispatcher", "DispatchStats",
           "ElasticServer", "ServeReport", "StreamReport", "StreamRequest",
           "StreamStateStore", "MultiStreamScheduler", "FleetScheduler",
           "fetch_valid", "CopyStreams", "LaneTickStep", "TickBufferPool",
           "donation_supported", "is_overlap_step", "ScalePolicy",
           "LaneAutoscaler", "ladder_rungs", "DEFAULT_RUNGS"]
