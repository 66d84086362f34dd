"""The ST communication core of the port: triggered-op IR, lowering,
schedule passes, the ST / host / fused executors, the cost simulator,
the schedule tuner (``core.autotune``), the Faces halo exchange, the
broadcast, ring and expert-parallel a2a transports (``core.broadcast``,
``core.ring``, ``core.ep_a2a``), the serving decode transport
(``core.serve_decode``) and the static schedule verifier with its
seeded-defect corpus (``core.verify``, ``core.defects``)."""
from repro_torch.core.stream import STStream, counters_expected
from repro_torch.core.window import STWindow
from repro_torch.core.triggered import (ResourcePool, TriggeredOp,
                                        TriggeredProgram)
from repro_torch.core.lower import lower_segment, split_segments
from repro_torch.core.patterns import (PatternTopology, STPattern,
                                       available_patterns, build_pattern,
                                       get_pattern, pattern_programs,
                                       register_pattern, simulate_pattern)
from repro_torch.core.schedule import (Segment, SegmentPlan, assign_streams,
                                       chunk_puts, node_aware_pass,
                                       pack_puts, plan_segments, schedule,
                                       stream_interleaved_order,
                                       validate_deps)
from repro_torch.core.engine import emit_node, run_fused
from repro_torch.core.throttle import (CostModel, faces_programs,
                                       host_dispatch_count, simulate_faces,
                                       simulate_pipeline, simulate_program)
from repro_torch.core.state import state_from_numpy, state_to_numpy
from repro_torch.core.verify import (Finding, ScheduleVerificationError,
                                     VerifyReport, find_cycle, verify,
                                     verify_programs)
from repro_torch.core import halo

__all__ = ["STStream", "STWindow", "TriggeredOp", "TriggeredProgram",
           "ResourcePool", "CostModel", "PatternTopology", "STPattern",
           "counters_expected", "lower_segment", "split_segments",
           "schedule", "assign_streams", "node_aware_pass", "pack_puts",
           "chunk_puts", "stream_interleaved_order",
           "plan_segments", "Segment", "SegmentPlan",
           "run_fused", "emit_node", "host_dispatch_count",
           "validate_deps", "register_pattern", "get_pattern",
           "available_patterns", "build_pattern", "pattern_programs",
           "simulate_pattern", "simulate_program", "simulate_pipeline",
           "simulate_faces", "faces_programs", "halo",
           "state_from_numpy", "state_to_numpy", "Finding", "VerifyReport",
           "ScheduleVerificationError", "verify", "verify_programs",
           "find_cycle"]
