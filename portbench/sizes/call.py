"""Every object the configuration's `call_bytes` long: the buffer that
the configuration's source hands to one call."""


def sizes(spec: dict, config: dict, count: int) -> list[int]:
    return [int(config["call_bytes"])] * count
