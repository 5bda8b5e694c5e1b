"""Control plane of the port.  So far the fault plane (``faults``): a
deterministic ``FaultPlane`` that injects device loss, worker and
ticker stalls and backpressure on a declarative schedule, with the
recovery wiring the flush and slot engines answer to.  The controller,
swapper, telemetry and tiers come with their own slice."""
from repro_torch.control.faults import (DeviceLostError, FaultEvent,
                                        FaultPlane, compound_schedule,
                                        slot_compound_schedule)

__all__ = ["DeviceLostError", "FaultEvent", "FaultPlane",
           "compound_schedule", "slot_compound_schedule"]
