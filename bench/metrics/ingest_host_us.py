"""Mean host microseconds of one ``DeviceIngest.ingest`` call (one 1-s
chunk of one modality) in the window, by the harness's clock."""


def read(obs):
    s = obs.get("ingest_s")
    return 1e6 * sum(s) / len(s) if s else None
