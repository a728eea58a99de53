"""Host wall ms of one physics call (``Driver.physics``), between two
synchronizes, over the physics span's steps."""


def read(ctx):
    if not ctx.physics_walls:
        return None
    return 1e3 * sum(ctx.physics_walls) / len(ctx.physics_walls)
