"""Time pretty-printing (reference Utils/seconds_to_biggest_unit.py:10-39).

A copy of ganmf_tpu/utils/timing.py, which uses no framework."""


def seconds_to_biggest_unit(time_in_seconds: float):
    conversion_factor = [("sec", 60), ("min", 60), ("hour", 24), ("day", 365)]
    terminate = False
    unit_index = 0
    new_time_value = time_in_seconds
    new_time_unit = "sec"
    while not terminate:
        next_time = new_time_value / conversion_factor[unit_index][1]
        if next_time >= 1.0:
            new_time_value = next_time
            unit_index += 1
            new_time_unit = conversion_factor[unit_index][0]
            if unit_index == len(conversion_factor) - 1:
                terminate = True
        else:
            terminate = True
    return new_time_value, new_time_unit
