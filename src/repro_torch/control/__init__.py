"""Control plane of the port: the closed loop from live serving
telemetry to ensemble composition.

``telemetry`` taps the serving data plane (``EnsembleServer``) for
sliding-window SLO signals and the online empirical arrival curve;
``controller`` turns those signals into actions (degradation-ladder
shed/climb, RE-PLACE, background recomposition); ``swap`` pre-stages
``(selector, placement)`` services over a shared ``StagingCache`` and
hot-swaps them atomically between flushes, re-places the active
selector from live shard costs and quarantines a lost lane; ``tiers``
lifts actuation to the acuity tier (one swapper a tier over one
staging cache, with a priority-aware ``TieredController``); ``faults``
injects device loss, worker and ticker stalls and backpressure on a
declarative schedule, with the recovery wiring the flush and slot
engines answer to, and ``wire_controller`` runs the controller against
a live server."""
from repro_torch.control.controller import (AdaptiveController,
                                            ControllerConfig, Decision,
                                            TieredController,
                                            TieredControllerConfig)
from repro_torch.control.faults import (DeviceLostError, FaultEvent,
                                        FaultPlane, compound_schedule,
                                        slot_compound_schedule,
                                        wire_controller)
from repro_torch.control.swap import (HotSwapper, SelectorLadder,
                                      StagingCache, SwappableService,
                                      rungs_monotone)
from repro_torch.control.telemetry import (SloTelemetry, TelemetrySnapshot,
                                           TieredTelemetry)
from repro_torch.control.tiers import (TIER_ORDER, TieredEnsemble,
                                       TierRegistry)

__all__ = ["AdaptiveController", "ControllerConfig", "Decision",
           "TieredController", "TieredControllerConfig",
           "DeviceLostError", "FaultEvent", "FaultPlane",
           "compound_schedule", "slot_compound_schedule",
           "wire_controller",
           "HotSwapper", "SelectorLadder", "StagingCache",
           "SwappableService", "rungs_monotone",
           "SloTelemetry", "TelemetrySnapshot", "TieredTelemetry",
           "TIER_ORDER", "TieredEnsemble", "TierRegistry"]
