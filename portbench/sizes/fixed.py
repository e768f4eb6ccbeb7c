"""Every object `bytes` long."""


def sizes(spec: dict, config: dict, count: int) -> list[int]:
    return [int(spec["bytes"])] * count
