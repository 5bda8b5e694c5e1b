"""Control plane of the port.  So far the actuator (``swap``): the
atomically swappable service facade, the selector degradation ladder
and ``HotSwapper``, which pre-stages ``(selector, placement)`` pairs
over a shared ``StagingCache``, re-places the active selector from live
shard costs and quarantines a lost lane; and the fault plane
(``faults``): a deterministic ``FaultPlane`` that injects device loss,
worker and ticker stalls and backpressure on a declarative schedule,
with the recovery wiring the flush and slot engines answer to.  The
controller, telemetry and tiers come with their own slice."""
from repro_torch.control.faults import (DeviceLostError, FaultEvent,
                                        FaultPlane, compound_schedule,
                                        slot_compound_schedule)
from repro_torch.control.swap import (HotSwapper, SelectorLadder,
                                      StagingCache, SwappableService,
                                      rungs_monotone)

__all__ = ["DeviceLostError", "FaultEvent", "FaultPlane",
           "compound_schedule", "slot_compound_schedule",
           "HotSwapper", "SelectorLadder", "StagingCache",
           "SwappableService", "rungs_monotone"]
