"""Seconds of host compile: the program compiled from the configuration, the
pool's maps built and the start tables made (compile_program, the map
builders, build_env_init), by the host clock around those calls."""


def read(ctx):
    return ctx.get("map_pool_s")
