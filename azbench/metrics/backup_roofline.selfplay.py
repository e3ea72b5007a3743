"""% of its roofline reached by the backup kernel: the least time of the
slice's searches' backup bytes at 3.35 TB/s (``yardstick.
search_backup_bytes``, from the configuration's shapes), over the traced
device time of ``round_backup_link_kernel``."""
import readers


def read(ctx):
    if ctx.get("kind") != "selfplay":
        return None
    kernel_s = readers.op_time(ctx, ctx["backup_kernel"])
    if not kernel_s or not ctx.get("backup_bound_s"):
        return None
    return 100.0 * ctx["backup_bound_s"] / kernel_s
