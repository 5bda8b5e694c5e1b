"""Share of the device time of the decode steps the profiled slice holds
whole that ran operations launched inside ``holmes.lm.shared`` (the
shared blocks' invocations: norm, attention, MLP, adapter, linear)."""


def read(obs):
    t = obs.get("step_trace")
    if not t or t["steps"] == 0 or t["step_device_s"] <= 0:
        return None
    return 100.0 * t["shared_device_s"] / t["step_device_s"]
