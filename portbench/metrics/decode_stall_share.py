"""The window's share of decode-ready phase time in which no decode ran
(``EngineStats.decode_stall_time_s / decode_ready_time_s``), in %."""


def read(run):
    ready = run.stats1.decode_ready_time_s - run.stats0.decode_ready_time_s
    stall = run.stats1.decode_stall_time_s - run.stats0.decode_stall_time_s
    return None if ready <= 0 else 100.0 * stall / ready
