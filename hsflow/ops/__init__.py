from hsflow.ops.stencils import derivatives, neighbor_avg, jacobi_step

__all__ = ["derivatives", "neighbor_avg", "jacobi_step"]
