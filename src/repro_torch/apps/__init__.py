"""The paper's six benchmark apps on :class:`~.common.TPContext`: the port
of ``repro.apps``.  :func:`all_apps` lists them in the order of the
reference's tuning cache."""


def all_apps():
    """JACOBI, KNN, PCA, DWT, SVM, CONV (fresh instances)."""
    from .conv import Conv
    from .dwt import Dwt
    from .jacobi import Jacobi
    from .knn import Knn
    from .pca import Pca
    from .svm import Svm
    return [Jacobi(), Knn(), Pca(), Dwt(), Svm(), Conv()]
