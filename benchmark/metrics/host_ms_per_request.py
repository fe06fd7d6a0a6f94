"""host_ms_per_request: host milliseconds from the call of a
`PreparedMesh` until it returns (before the output's copy to the host
waits for the card), over the window's requests."""


def read(record):
    w = record["window"]
    if not w.get("requests"):
        return None
    return 1e3 * w["call_s"] / w["requests"]
