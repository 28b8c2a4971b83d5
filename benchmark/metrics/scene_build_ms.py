"""Host ms of the scene's load and device build in set-up
(``load_vox_scene`` + ``build_device_scene``, synchronised)."""


def read(run):
    return 1e3 * run.scene_build_s
